// fp8 (e4m3) weight-streaming matmul for decode, sm_90a: a few bf16 rows of
// activations against an e4m3 weight that is cast inside the kernel, never
// into device memory.
//
// Replaces the Pallas TPU kernel of benchmarks/fp8_decode_probe.py:
// `_fp8_kernel` (through `fp8_matmul`).
//
//   y[M, N] = bf16( (x[M, K] @ float(w[N, K])^T) * scale[N] )
//
//   x      bf16 [M, K], row stride ldx elements.
//   w      float8_e4m3fn, one row per output channel, row stride ldw bytes:
//          the probe's [K, N] leaf transposed, so that the K bytes of one
//          channel are contiguous.
//   scale  fp32 [N], applied to the fp32 sum; the result is rounded to bf16
//          once. Every e4m3 value is a bf16 value, so the cast is exact and
//          the products are those of the probe kernel.
//   M, N and K are any size: edges are predicated and zero-filled here, not
//   padded by the caller.
//
// What bounds it. At decode (M <= 8) each weight byte is used M times: the
// N * K weight bytes are nearly all the traffic, and the time is bounded by
// reading them once from device memory. Everything else serves that stream.
//
// Design: a matvec with the operands swapped. y^T [N, M] = w [N, K] . x^T
// [K, M], so one mma.sync m16n8k16 takes 16 output channels as its rows (A,
// the converted weight) and 8 rows of x as its columns (B): the decode rows
// fill the mma's n = 8, and no 128-row tile is wasted on M = 1..8. A block
// owns 16 channels and 8 rows of x and its 8 warps split K: warp w takes the
// 64-wide K steps w, w + 8, ... , four of them in flight at a time. In a
// step, lane 4g + t reads 16 contiguous weight bytes of channels g and g + 8
// at K offset 16t (one 16-byte load each, not kept in L1) and the 16 bf16 of
// x row g at the same offsets (two 16-byte loads). The mma's K order inside
// a step is free as long as A and B agree, so the thread's mma slots
// {2t, 2t+1, 2t+8, 2t+9} of sub-step j hold its own K positions 16t + 4j +
// {0, 1, 2, 3}: every operand comes straight from the registers the loads
// filled, with no shuffle and no shared memory. e4m3 pairs go to f16 pairs
// by the hardware cvt (exact), then to fp32 and to a bf16 pair (exact). The
// eight warps' accumulators are summed through shared memory, and warp 0
// applies the scale and stores.
//
// For M > 8 the grid's second dimension walks blocks of 8 rows of x, each
// reading the weight again. Loads are 16 bytes wide when the pointer and the
// row stride allow it (w: ldw a multiple of 16 bytes; x: ldx a multiple of 8
// elements) and the 16 K positions lie below K; otherwise that span is
// gathered element by element, which is slow and meant for odd shapes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_fragments.cuh"

namespace {

constexpr int ROWS = 8;     // rows of x per block: the mma's n
constexpr int CH = 16;      // output channels per block: the mma's m
constexpr int KSTEP = 64;   // K per warp step: 4 lanes x 16 bytes
constexpr int WARPS = 8;
constexpr int NTHREADS = 32 * WARPS;
constexpr int UNROLL = 4;   // steps in flight per warp

// 16 weight bytes of a channel row from byte kk; zero beyond K or for a
// channel that does not exist. The vector load bypasses L1: each weight byte
// is read once.
__device__ __forceinline__ uint4 load_w(const unsigned char* __restrict__ row, long long kk,
                                        int K, bool ok, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!ok || kk >= K) return v;
  if (vec && kk + 16 <= K) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(row + kk));
    return v;
  }
  uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (kk + i < K) b[i / 4] |= static_cast<uint32_t>(row[kk + i]) << (8 * (i % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// 16 bf16 of a row of x from element kk, as 8 bf16 pairs; zero beyond K or
// for a row that does not exist
__device__ __forceinline__ void load_x(uint32_t (&v)[8], const __nv_bfloat16* __restrict__ row,
                                       long long kk, int K, bool ok, bool vec) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0;
  if (!ok || kk >= K) return;
  if (vec && kk + 16 <= K) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + kk));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + kk + 8));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (kk + i < K)
      v[i / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(row[kk + i])) << (16 * (i % 2));
}

// two e4m3 bytes (low byte first) -> one register of two bf16, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t pair) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFF),
                                             __NV_E4M3));
  const float2 f = __half22float2(h);
  return pack_f32(f.x, f.y);
}

__global__ void __launch_bounds__(NTHREADS)
    fp8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M,
                      int N, int K, long long ldx, long long ldw, long long ldy, bool vec_x,
                      bool vec_w) {
  __shared__ float4 partial[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * CH, m0 = blockIdx.y * ROWS;
  const bool lo_ok = n0 + g < N, hi_ok = n0 + g + 8 < N, x_ok = m0 + g < M;
  const unsigned char* w_lo = w + static_cast<long long>(n0 + g) * ldw;
  const unsigned char* w_hi = w_lo + 8 * ldw;
  const __nv_bfloat16* xr = x + static_cast<long long>(m0 + g) * ldx;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // (channel g, rows 2t, 2t+1), (channel g + 8, ...)
  const int steps = (K + KSTEP - 1) / KSTEP;
  for (int s0 = warp; s0 < steps; s0 += WARPS * UNROLL) {
    uint4 wl[UNROLL], wh[UNROLL];
    uint32_t xv[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * WARPS;
      const long long kk = static_cast<long long>(s) * KSTEP + 16 * t;
      const bool in = s < steps;
      wl[u] = load_w(w_lo, kk, K, lo_ok && in, vec_w);
      wh[u] = load_w(w_hi, kk, K, hi_ok && in, vec_w);
      load_x(xv[u], xr, kk, K, x_ok && in, vec_x);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t lo[4] = {wl[u].x, wl[u].y, wl[u].z, wl[u].w};
      const uint32_t hi[4] = {wh[u].x, wh[u].y, wh[u].z, wh[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // K positions 16t + 4j .. 16t + 4j + 3
        const uint32_t a[4] = {e4m3x2_to_bf16x2(lo[j]), e4m3x2_to_bf16x2(hi[j]),
                               e4m3x2_to_bf16x2(lo[j] >> 16), e4m3x2_to_bf16x2(hi[j] >> 16)};
        mma_16816(acc, a, xv[u][2 * j], xv[u][2 * j + 1]);
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
    if (n < N && m < M) y[m * ldy + n] = __float2bfloat16_rn(sum[i] * scale[n]);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else the cudaError_t of the failed launch. Dtypes,
// shapes and devices are checked by the Python wrapper. ldx and ldy are row
// strides in elements, ldw in bytes.
int aigv_fp8_matmul(const void* x, const void* w, const void* scale, void* y, int M, int N,
                    int K, long long ldx, long long ldw, long long ldy, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < K || ldy < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + CH - 1) / CH, (M + ROWS - 1) / ROWS);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0;
  fp8_matmul_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, N, K, ldx, ldw, ldy,
      vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
