// Tensor-core fragment helpers shared by the flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu) and the weight-only matmuls
// (weight_only_matmul.cu): mma.sync m16n8k16 bf16 with fp32
// accumulation, and its operands loaded from padded row-major shared-memory
// tiles with ldmatrix.
//
// Fragment layout of mma.m16n8k16, for lane = 4 * g + t:
//   A (16 x 16, row-major): a[0] = (row g, k 2t..2t+1), a[1] = row g + 8,
//                           a[2] = (row g, k 2t + 8..), a[3] = row g + 8, k + 8
//   B (16 x 8, "col"):      b0 = (k 2t..2t+1, n g), b1 = k + 8
//   C / D (16 x 8):         d[0], d[1] = (row g, n 2t..2t+1), d[2], d[3] = row g + 8
// so the accumulators of two neighbouring 8-column tiles, rounded to bf16,
// are the A fragment of the next product's 16-wide k step.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

constexpr int PAD = 8;  // bf16 elements of padding per smem row: 16-byte rows on distinct banks

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory in one instruction. Lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned);
// r[i] holds this thread's two elements of matrix i: row g, columns 2t and
// 2t + 1, or with TRANS column g, rows 2t and 2t + 1.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

// A fragment (16 rows x 16 k) of a row-major smem tile with row stride LD:
// rows row0..row0 + 15, k columns k0..k0 + 15
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int k0, int lane) {
  ldmatrix_x4<false>(a, tile + (row0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// Two B fragments (16 k x 8 n each) with n along the tile's rows and k along
// its columns (the tile is the transposed operand, as K in Q K^T): b[0], b[1]
// for n = row0.. and b[2], b[3] for n = row0 + 8.., k = k0..k0 + 15
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int row0, int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4<false>(b, tile + (row0 + (mi >> 1) * 8 + (lane & 7)) * LD + k0 + (mi & 1) * 8);
}

// Two B fragments (16 k x 8 n each) with k along the tile's rows and n along
// its columns (as V in P V), transposed on the way in: b[0], b[1] for
// n = col0.. and b[2], b[3] for n = col0 + 8.., k = row0..row0 + 15
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int row0, int col0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4<true>(b, tile + (row0 + (mi & 1) * 8 + (lane & 7)) * LD + col0 + (mi >> 1) * 8);
}
