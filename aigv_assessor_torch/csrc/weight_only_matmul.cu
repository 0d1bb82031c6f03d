// Weight-only quantized matmuls (W8A16, W4A16) for sm_90a: bf16 activations
// against int8 or nibble-packed int4 weights that are decoded inside the
// kernel, never into device memory.
//
// Replaces the Pallas TPU kernels of aigv_assessor_tpu/ops/int8_matmul.py:
// `_kernel` (through `int8_matmul`) and `_int4_kernel` (through
// `int4_matmul`).
//
//   y[M, N] = bf16( (x[M, K] @ decode(w)[N, K]^T) * scale[N] (+ bias[N]) )
//
//   x      bf16 [M, K], row stride ldx elements.
//   w      int8, one row per output channel, row stride ldw bytes:
//          int8: [N, K], byte k of row n is weight (k, n);
//          int4: [N, ceil(K/2)], byte j of row n packs weights (2j, n) in
//          its low nibble and (2j + 1, n) in its high nibble, both signed.
//          This is the TPU kernels' [K, N] / [ceil(K/2), N] layout
//          transposed, so that the K values of one output channel are
//          contiguous, which is the order the tensor-core B operand wants.
//   scale  fp32 [N], applied to the fp32 sum; bias bf16 [N] or null, added
//          in fp32; the result is rounded to bf16 once.
//   M, N and K are any size. Edges are handled here with predicated loads
//   and zero fill, not with padded copies: a zero weight byte decodes to 0
//   in both formats, and x is zero-filled beyond K.
//
// Design. One block of 8 warps per 128 x 128 tile of y, looping over K in
// steps of 32. Each step's x tile and decoded weight tile sit in shared
// memory as bf16; the next step's tiles are read from device memory into
// registers while the current ones are multiplied (two buffers, one
// __syncthreads per step). The weight bytes are decoded once per tile, on
// the way from registers to shared memory: a byte biased to unsigned goes
// into the mantissa of 2^23 as an fp32, the bias is subtracted (exact), and
// the top 16 bits of the result are its bf16 (exact for |q| <= 128). That is
// integer and fp32 work, without conversion instructions. The TPU int4
// kernel splits x into even and odd K columns to use the nibbles in place;
// here a [BN, BK/2] byte tile becomes a [BN, BK] bf16 tile with the two
// nibbles of a byte in neighbouring K positions, and x is left alone: the
// same sum. Each warp owns 64 x 32 of the tile: mma.sync m16n8k16 bf16 with
// fp32 accumulation, fragments through ldmatrix (mma_fragments.cuh).
//
// Loads are 16 bytes wide when the pointers, the row strides and K allow it
// (x: K and ldx multiples of 8; w: row bytes and ldw multiples of 16);
// otherwise that operand is gathered byte by byte, which is slow and meant
// for odd test shapes only.
//
// What bounds it. At the prefill shapes (M = 8452, K and N in the
// thousands) the product is compute-bound: 2*M*N*K operations against
// 2*M*K + N*K (or N*K/2) + 2*M*N bytes is above a thousand FLOP per byte.
// This version is far from the tensor-core rate: mma.sync, not wgmma, and
// register-staged loads instead of TMA. At the decode shapes (M = 1, 4) the
// weight bytes bound it, and a 128-row tile wastes the tensor cores and
// leaves most SMs idle when N / 128 is below their number; a GEMV-shaped
// kernel for that case is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_fragments.cuh"

namespace {

constexpr int BM = 128;  // rows of y per block
constexpr int BN = 128;  // columns of y per block
constexpr int BK = 32;   // K per step
constexpr int NTHREADS = 256;
constexpr int LD = BK + PAD;  // smem row stride, elements
constexpr int WM = 64;        // rows per warp: warps are laid out 2 x 4
constexpr int WN = 32;        // columns per warp
constexpr int A_CHUNKS = BM * BK / 8 / NTHREADS;  // 16-byte chunks of x per thread: 2

enum Bits { INT8 = 8, INT4 = 4 };

// 16 bytes of a row starting at byte `off`; zero where the row does not
// exist or the bytes lie at or beyond `valid`. With `vec`, valid is a
// multiple of 16 and the address is 16-byte aligned.
__device__ __forceinline__ uint4 load_chunk(const unsigned char* __restrict__ row, long long off,
                                            long long valid, bool row_ok, bool vec) {
  if (!row_ok || off >= valid) return make_uint4(0, 0, 0, 0);
  if (vec) return *reinterpret_cast<const uint4*>(row + off);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (off + i < valid) w[i >> 2] |= static_cast<uint32_t>(row[off + i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The four bytes of u, each a small unsigned integer, as floats minus
// `bias - 2^23`: byte b becomes the fp32 with mantissa b and exponent 23,
// which is 2^23 + b exactly.
__device__ __forceinline__ void bytes_to_floats(uint32_t u, float bias, float (&f)[4]) {
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
}

// two floats that bf16 holds exactly -> one register of two bf16, `lo` in
// the low half: their top 16 bits
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// four int8 weights of consecutive K -> four bf16
__device__ __forceinline__ uint2 decode_int8(uint32_t w) {
  float f[4];
  bytes_to_floats(w ^ 0x80808080u, 8388608.f + 128.f, f);
  return make_uint2(pack_exact(f[0], f[1]), pack_exact(f[2], f[3]));
}

// four bytes = eight int4 weights of consecutive K (low nibble first) ->
// eight bf16. A two's-complement nibble q is (q + 8) after flipping bit 3.
__device__ __forceinline__ uint4 decode_int4(uint32_t w) {
  float lo[4], hi[4];
  bytes_to_floats((w & 0x0F0F0F0Fu) ^ 0x08080808u, 8388608.f + 8.f, lo);
  bytes_to_floats(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8388608.f + 8.f, hi);
  return make_uint4(pack_exact(lo[0], hi[0]), pack_exact(lo[1], hi[1]),
                    pack_exact(lo[2], hi[2]), pack_exact(lo[3], hi[3]));
}

template <int BITS>
__global__ void __launch_bounds__(NTHREADS, 2)
weight_only_matmul_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w,
                          const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ y, int M, int N, int K, long long ldx,
                          long long ldw, long long ldy, bool vec_x, bool vec_w) {
  // int8: two 16-byte chunks (16 K each) per weight row and step, one per
  // thread; int4: one chunk (32 K) per row, threads 0..BN-1
  constexpr int W_CHUNKS = BITS == INT8 ? 2 : 1;
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM * LD];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BN * LD];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;

  const auto* xb = reinterpret_cast<const unsigned char*>(x);
  const long long x_valid = 2LL * K;                         // bytes of one x row
  const long long w_valid = BITS == INT8 ? K : (K + 1) / 2;  // bytes of one weight row
  const int w_row = tid / W_CHUNKS, w_chunk = tid % W_CHUNKS;
  const bool w_loads = tid < BN * W_CHUNKS;

  uint4 ra[A_CHUNKS], rb = make_uint4(0, 0, 0, 0);
  auto load_tile = [&](int kt) {
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (BK / 8), c = i % (BK / 8);
      ra[j] = load_chunk(xb + (m0 + r) * ldx * 2, (static_cast<long long>(kt) * BK + c * 8) * 2,
                         x_valid, m0 + r < M, vec_x);
    }
    if (w_loads)
      rb = load_chunk(w + (n0 + w_row) * ldw,
                      static_cast<long long>(kt) * (BK * BITS / 8) + w_chunk * 16, w_valid,
                      n0 + w_row < N, vec_w);
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (BK / 8), c = i % (BK / 8);
      *reinterpret_cast<uint4*>(&sA[buf][r * LD + c * 8]) = ra[j];
    }
    if (w_loads) {
      __nv_bfloat16* dst = &sB[buf][w_row * LD + w_chunk * 16];
      if constexpr (BITS == INT8) {
        const uint2 d0 = decode_int8(rb.x), d1 = decode_int8(rb.y);
        const uint2 d2 = decode_int8(rb.z), d3 = decode_int8(rb.w);
        *reinterpret_cast<uint4*>(dst) = make_uint4(d0.x, d0.y, d1.x, d1.y);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(d2.x, d2.y, d3.x, d3.y);
      } else {
        *reinterpret_cast<uint4*>(dst) = decode_int4(rb.x);
        *reinterpret_cast<uint4*>(dst + 8) = decode_int4(rb.y);
        *reinterpret_cast<uint4*>(dst + 16) = decode_int4(rb.z);
        *reinterpret_cast<uint4*>(dst + 24) = decode_int4(rb.w);
      }
    }
  };

  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_steps = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < n_steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_steps) load_tile(kt + 1);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[WM / 16][4], bf[WN / 16][4];
#pragma unroll
      for (int mt = 0; mt < WM / 16; ++mt) load_a<LD>(af[mt], sA[buf], wm + mt * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < WN / 16; ++np)
        load_b_rows<LD>(bf[np], sB[buf], wn + np * 16, ks * 16, lane);
#pragma unroll
      for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt)
          mma_16816(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
    // the other buffer was last read in the previous step, before its barrier
    if (kt + 1 < n_steps) store_tile(buf ^ 1);
    __syncthreads();
  }

  // y = acc * scale (+ bias) in fp32, rounded to bf16 once. Two neighbouring
  // columns go out as one 4-byte store when every row of y keeps them aligned.
  const int gr = lane >> 2, tq = lane & 3;
  const bool pair_ok = ldy % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < WN / 8; ++nt) {
    const int c = n0 + wn + nt * 8 + tq * 2;
    if (c >= N) continue;
    const bool two = c + 1 < N;
    const float s0 = scale[c], s1 = two ? scale[c + 1] : 0.f;
    const float b0 = bias != nullptr ? __bfloat162float(bias[c]) : 0.f;
    const float b1 = bias != nullptr && two ? __bfloat162float(bias[c + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < WM / 16; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + gr + half * 8;
        if (r >= M) continue;
        const float v0 = acc[mt][nt][2 * half] * s0 + b0;
        const float v1 = acc[mt][nt][2 * half + 1] * s1 + b1;
        __nv_bfloat16* dst = y + r * ldy + c;
        if (two && pair_ok) {
          *reinterpret_cast<uint32_t*>(dst) = pack_f32(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (two) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int BITS>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* y, int M,
           int N, int K, long long ldx, long long ldw, long long ldy, void* stream) {
  const long long w_bytes = BITS == INT8 ? K : (K + 1) / 2;
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < w_bytes || ldy < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0 && K % 8 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0 && w_bytes % 16 == 0;
  weight_only_matmul_kernel<BITS><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, ldx, ldw, ldy, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both return 0 on success, else the cudaError_t of the failed launch.
// Dtypes, shapes and devices are checked by the Python wrappers. ldx and ldy
// are row strides in elements, ldw in bytes; bias may be null.

int aigv_weight_only_int8_matmul(const void* x, const void* w, const void* scale,
                                 const void* bias, void* y, int M, int N, int K, long long ldx,
                                 long long ldw, long long ldy, void* stream) {
  return launch<INT8>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

int aigv_weight_only_int4_matmul(const void* x, const void* w, const void* scale,
                                 const void* bias, void* y, int M, int N, int K, long long ldx,
                                 long long ldw, long long ldy, void* stream) {
  return launch<INT4>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
