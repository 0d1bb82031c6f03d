// The decode matvec shared by the fp8 matmul (fp8_matmul.cu, K9) and the GEMV
// form of the weight-only matmuls (weight_only_matmul.cu, K6 / K7): a few bf16
// rows of activations against a weight of one value per byte (fp8, int8) or
// two (packed int4), converted in registers, never into device memory.
//
//   y[M, N] = bf16( (x[M, K] @ convert(w)[N, K]^T) * scale[N] (+ bias[N]) )
//
//   x      bf16 [M, K], row stride ldx elements.
//   w      one row of ceil(K / KPB) bytes per output channel, row stride ldw
//          bytes, the K values of a channel in order (int4: low nibble first).
//   scale  fp32 [N], applied to the fp32 sum; bias bf16 [N] or null, added in
//          fp32; the result is rounded to bf16 once.
//   M, N and K are any size: edges are predicated and zero-filled here, not
//   padded by the caller.
//
// What bounds it. At decode (M <= 8) each weight byte is used M times: the
// weight bytes are nearly all the traffic, and the time is bounded by reading
// them once from device memory. Everything else serves that stream.
//
// Design: a matvec with the operands swapped. y^T [N, M] = w [N, K] . x^T
// [K, M], so one mma.sync m16n8k16 takes 16 output channels as its rows (A,
// the converted weight) and 8 rows of x as its columns (B): the decode rows
// fill the mma's n = 8, and no 128-row tile is wasted on M = 1..8. A block
// owns 16 channels and 8 rows of x and its 8 warps split K: warp w takes the
// 64-byte weight steps w, w + 8, ... , four of them in flight at a time. In a
// step, lane 4g + t reads 16 contiguous weight bytes of channels g and g + 8
// at byte offset 16t (one 16-byte load each, not kept in L1) and the 16 * KPB
// values of x row g that those bytes hold (2 * KPB 16-byte loads). The mma's
// K order inside a step is free as long as A and B agree: each 4-byte word of
// the weight converts to 2 * KPB bf16 pairs of consecutive K (`Fmt::convert`),
// and pairs 2i and 2i + 1 of both channels, with x's pairs at the same K, are
// the operands of the word's mma i. So every operand comes straight from the
// registers the loads filled, with no shuffle and no shared memory. The eight
// warps' accumulators are summed through shared memory, and warp 0 applies
// the scale and the bias and stores.
//
// For M > 8 the grid's second dimension walks blocks of 8 rows of x, each
// reading the weight again. Loads are 16 bytes wide when the pointer and the
// row stride allow it (w: ldw a multiple of 16 bytes; x: ldx a multiple of 8
// elements) and the 16 values lie below the row's end; otherwise that span is
// gathered element by element, which is slow and meant for odd shapes and
// the last span of an odd K.
//
// A format is a struct with
//   static constexpr int KPB;  // weight values per byte: 1 or 2
//   static __device__ void convert(uint32_t word, uint32_t (&pairs)[2 * KPB]);
// where `convert` turns four weight bytes into 2 * KPB registers of two bf16
// each, the values in K order, lower K in the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_fragments.cuh"

namespace decode_matvec {

constexpr int ROWS = 8;     // rows of x per block: the mma's n
constexpr int CH = 16;      // output channels per block: the mma's m
constexpr int KSTEP = 64;   // weight bytes per warp step: 4 lanes x 16 bytes
constexpr int WARPS = 8;
constexpr int NTHREADS = 32 * WARPS;
constexpr int UNROLL = 4;   // steps in flight per warp

// 16 weight bytes of a channel row from byte kb; zero beyond the row's
// `valid` bytes or for a channel that does not exist. The vector load
// bypasses L1: each weight byte is read once.
__device__ __forceinline__ uint4 load_w(const unsigned char* __restrict__ row, long long kb,
                                        long long valid, bool ok, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!ok || kb >= valid) return v;
  if (vec && kb + 16 <= valid) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(row + kb));
    return v;
  }
  uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (kb + i < valid) b[i / 4] |= static_cast<uint32_t>(row[kb + i]) << (8 * (i % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// 16 * SPANS bf16 of a row of x from element kk, as 8 * SPANS bf16 pairs;
// zero beyond K or for a row that does not exist
template <int SPANS>
__device__ __forceinline__ void load_x(uint32_t (&v)[8 * SPANS],
                                       const __nv_bfloat16* __restrict__ row, long long kk, int K,
                                       bool ok, bool vec) {
#pragma unroll
  for (int i = 0; i < 8 * SPANS; ++i) v[i] = 0;
  if (!ok) return;
#pragma unroll
  for (int s = 0; s < SPANS; ++s) {
    const long long k0 = kk + 16 * s;
    if (k0 >= K) return;
    if (vec && k0 + 16 <= K) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + k0));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + k0 + 8));
      v[8 * s + 0] = a.x, v[8 * s + 1] = a.y, v[8 * s + 2] = a.z, v[8 * s + 3] = a.w;
      v[8 * s + 4] = b.x, v[8 * s + 5] = b.y, v[8 * s + 6] = b.z, v[8 * s + 7] = b.w;
      continue;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k0 + i < K)
        v[8 * s + i / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(row[k0 + i]))
                            << (16 * (i % 2));
  }
}

template <class Fmt>
__global__ void __launch_bounds__(NTHREADS)
    decode_matvec_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w,
                         const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, int M, int N, int K, long long ldx,
                         long long ldw, long long ldy, bool vec_x, bool vec_w) {
  constexpr int KPB = Fmt::KPB;
  __shared__ float4 partial[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * CH, m0 = blockIdx.y * ROWS;
  const bool lo_ok = n0 + g < N, hi_ok = n0 + g + 8 < N, x_ok = m0 + g < M;
  const unsigned char* w_lo = w + static_cast<long long>(n0 + g) * ldw;
  const unsigned char* w_hi = w_lo + 8 * ldw;
  const __nv_bfloat16* xr = x + static_cast<long long>(m0 + g) * ldx;
  const long long w_valid = (static_cast<long long>(K) + KPB - 1) / KPB;  // bytes of a row

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // (channel g, rows 2t, 2t+1), (channel g + 8, ...)
  const int steps = static_cast<int>((w_valid + KSTEP - 1) / KSTEP);
  for (int s0 = warp; s0 < steps; s0 += WARPS * UNROLL) {
    uint4 wl[UNROLL], wh[UNROLL];
    uint32_t xv[UNROLL][8 * KPB];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * WARPS;
      const long long kb = static_cast<long long>(s) * KSTEP + 16 * t;
      const bool in = s < steps;
      wl[u] = load_w(w_lo, kb, w_valid, lo_ok && in, vec_w);
      wh[u] = load_w(w_hi, kb, w_valid, hi_ok && in, vec_w);
      load_x<KPB>(xv[u], xr, kb * KPB, K, x_ok && in, vec_x);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t lo[4] = {wl[u].x, wl[u].y, wl[u].z, wl[u].w};
      const uint32_t hi[4] = {wh[u].x, wh[u].y, wh[u].z, wh[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // K of the word: 4 KPB j .. 4 KPB j + 4 KPB - 1
        uint32_t pl[2 * KPB], ph[2 * KPB];
        Fmt::convert(lo[j], pl);
        Fmt::convert(hi[j], ph);
#pragma unroll
        for (int i = 0; i < KPB; ++i) {
          const uint32_t a[4] = {pl[2 * i], ph[2 * i], pl[2 * i + 1], ph[2 * i + 1]};
          mma_16816(acc, a, xv[u][2 * KPB * j + 2 * i], xv[u][2 * KPB * j + 2 * i + 1]);
        }
      }
    }
  }

  partial[warp][lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (warp != 0) return;
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    const float4 p = partial[i][lane];
    sum[0] += p.x, sum[1] += p.y, sum[2] += p.z, sum[3] += p.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + g + (i >= 2 ? 8 : 0), m = m0 + 2 * t + (i & 1);
    if (n < N && m < M) {
      const float b = bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
      y[m * ldy + n] = __float2bfloat16_rn(sum[i] * scale[n] + b);
    }
  }
}

// Checks the arguments, picks the load widths and launches; returns the
// cudaError_t of the launch (0 on success).
template <class Fmt>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* y, int M,
           int N, int K, long long ldx, long long ldw, long long ldy, void* stream) {
  const long long w_valid = (static_cast<long long>(K) + Fmt::KPB - 1) / Fmt::KPB;
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < w_valid || ldy < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + CH - 1) / CH, (M + ROWS - 1) / ROWS);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0;
  decode_matvec_kernel<Fmt><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, ldx, ldw, ldy, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_matvec
