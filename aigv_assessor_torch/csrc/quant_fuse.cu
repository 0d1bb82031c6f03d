// Fused producer + per-row int8 quantize, for sm_90a.
//
// Replaces the Pallas TPU kernels of aigv_assessor_tpu/ops/quant_fuse.py that
// the W8A8 towers run, as one kernel templated on the producer:
//   K4a `_ln_quant_kernel`       (entry `layernorm_quant`): LayerNorm -> int8
//   K4b `_gelu_quant_kernel`     (entry `gelu_quant`):      tanh-GELU -> int8
//   K4c `_ident_quant_kernel`    (entry `quant_rows`):      identity  -> int8
//   K5a `_rms_quant_kernel`      (entry `rmsnorm_quant`):   RMSNorm   -> int8
//   K5b `_silu_mul_quant_kernel` (entry `silu_mul_quant`):  silu(x) * x2 -> int8
//
//   x      [rows, C] bf16, contiguous; x2 [rows, C] bf16 (silu-mul only);
//          gamma [C] bf16 (both norms), beta [C] bf16 (LayerNorm only)
//   y      = producer(x) in fp32
//   scale  [rows] fp32 = max(max_j |y_j|, 1e-8) / 127
//   q      [rows, C] int8 = clip(rint(y / scale), -127, 127)
//
// Numerics follow the JAX fallbacks (`_layernorm_quant_xla`,
// `_gelu_quant_xla`, `_rmsnorm_quant_xla`, `_silu_mul_quant_xla`,
// `ops/w8a8.quantize_rows`) op for op, because each of these choices flips
// int8 values: the LayerNorm variance in two passes, mean((x - mu)^2); a
// correctly rounded rsqrt (__frsqrt_rn, not rsqrtf); RMSNorm's weight applied
// to the fp32 product x * rsqrt(mean(x^2) + eps), never to a rounded copy;
// sigmoid as 1 / (1 + expf(-x)) with the accurate expf and an IEEE division,
// as `jax.lax.logistic`; an IEEE division y / s, not y * (1 / s); rounding
// half to even (rintf, not roundf); an accurate tanhf, not tanh.approx; and
// every product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction), as the eager plain version rounds them. The row sums are
// taken in another order than the plain version's, so where y / s lies
// within an ulp of a half an int8 value can differ by one.
//
// Design. One block per row; the row stays in registers. A block of 128
// threads takes rows of up to 8192 values, one of 256 threads rows of up to
// 16384 (the 8B decoder's 14336-wide SwiGLU feed). Each thread loads CHUNKS
// 16-byte vectors of 8 bf16 (C <= CHUNKS * THREADS * 8), the block reduces
// (sum, then sum of squared deviations, then absmax) with warp shuffles and
// a small shared array, and each thread stores its 8 int8 values as one
// 8-byte word. The silu-mul producer reads its second input vector by vector
// and folds it in at once, so only y stays in registers. Nothing is padded:
// the last vectors of a row shorter than the block's reach are masked.
//
// What bounds it. Bytes: every element is read once as bf16 (twice for
// silu-mul, one per input) and written once as int8, with no matrix
// product. On the W8A8 ViT path K4a and K4c move 0.10 GB (33024 x 1024) and
// K4b 0.41 GB (33024 x 4096) a launch, 0.03 ms and 0.12 ms at the H100's
// 3.35 TB/s; on the 2B decoder K5a moves 51.9 MB (8452 x 2048), 0.0155 ms,
// and K5b 346.2 MB (two 8452 x 8192 inputs), 0.1033 ms. The reductions'
// latency is hidden by the blocks an SM holds at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;  // bf16 values per 16-byte load
constexpr int MAX_CHUNKS = 8;  // 16-byte vectors a thread holds
constexpr int SMALL_BLOCK = 128, LARGE_BLOCK = 256;
constexpr float kSqrt2OverPi = 0.7978845608028654f;

enum Producer { kIdentity = 0, kLayerNorm = 1, kGeluTanh = 2, kRmsNorm = 3, kSiluMul = 4 };

// Sum over the block; every thread gets the same value (the warps' partial
// sums are added in a fixed order).
template <int WARPS>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffff, v, o));
  __syncthreads();  // the previous reduction's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) t = __fadd_rn(t, red[w]);
  return t;
}

template <int WARPS>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) t = fmaxf(t, red[w]);
  return t;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = __bfloat162float(h[e]);
}

template <int THREADS, int CHUNKS, int PRODUCER>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ x2,
                  const __nv_bfloat16* __restrict__ gamma,
                  const __nv_bfloat16* __restrict__ beta, float eps, int8_t* __restrict__ q,
                  float* __restrict__ scale, int cols) {
  constexpr int WARPS = THREADS / 32;
  constexpr int ROW_TILE = THREADS * VEC;  // elements one pass of the block covers
  __shared__ float red[WARPS];
  const long long row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * cols;

  float y[CHUNKS][VEC];
  bool valid[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = c * ROW_TILE + threadIdx.x * VEC;
    valid[c] = col < cols;
    if (valid[c]) {
      load8(xr + col, y[c]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[c][e] = 0.f;
    }
  }

  if (PRODUCER == kLayerNorm) {
    const float n = static_cast<float>(cols);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = __fadd_rn(acc, y[c][e]);  // masked values are 0
    const float mu = __fdiv_rn(block_sum<WARPS>(acc, red), n);
    acc = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (!valid[c]) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = __fsub_rn(y[c][e], mu);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
    }
    const float var = __fdiv_rn(block_sum<WARPS>(acc, red), n);
    const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (!valid[c]) continue;
      const int col = c * ROW_TILE + threadIdx.x * VEC;
      float g[VEC], b[VEC];
      load8(gamma + col, g);
      load8(beta + col, b);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        y[c][e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y[c][e], mu), rstd), g[e]), b[e]);
    }
  } else if (PRODUCER == kRmsNorm) {
    // x * rsqrt(mean(x^2) + eps), then * gamma, each in fp32
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = __fadd_rn(acc, __fmul_rn(y[c][e], y[c][e]));
    const float ms = __fdiv_rn(block_sum<WARPS>(acc, red), static_cast<float>(cols));
    const float r = __frsqrt_rn(__fadd_rn(ms, eps));
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (!valid[c]) continue;
      float g[VEC];
      load8(gamma + c * ROW_TILE + threadIdx.x * VEC, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[c][e] = __fmul_rn(__fmul_rn(y[c][e], r), g[e]);
    }
  } else if (PRODUCER == kSiluMul) {
    // x * (1 / (1 + exp(-x))) * x2
    const __nv_bfloat16* x2r = x2 + row * cols;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (!valid[c]) continue;
      float h3[VEC];
      load8(x2r + c * ROW_TILE + threadIdx.x * VEC, h3);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = y[c][e];
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
        y[c][e] = __fmul_rn(__fmul_rn(v, sig), h3[e]);
      }
    }
  } else if (PRODUCER == kGeluTanh) {
    // 0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x * x * x))), each
    // product and sum rounded in this order
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = y[c][e];
        const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, v), v), v);
        const float t = tanhf(__fmul_rn(kSqrt2OverPi, __fadd_rn(v, cube)));
        y[c][e] = __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, t));
      }
  }

  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (!valid[c]) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(y[c][e]));
  }
  const float s = __fdiv_rn(fmaxf(block_max<WARPS>(amax, red), 1e-8f), 127.0f);

  int8_t* qr = q + row * cols;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (!valid[c]) continue;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(y[c][e], s)), -127.f), 127.f);
      const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(r)));
      w[e / 4] |= byte << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(qr + c * ROW_TILE + threadIdx.x * VEC) = make_uint2(w[0], w[1]);
  }
  if (threadIdx.x == 0) scale[row] = s;
}

template <int THREADS, int CHUNKS, int PRODUCER>
void launch_one(const __nv_bfloat16* x, const __nv_bfloat16* x2, const __nv_bfloat16* gamma,
                const __nv_bfloat16* beta, float eps, int8_t* q, float* scale, long long rows,
                int cols, cudaStream_t stream) {
  quant_rows_kernel<THREADS, CHUNKS, PRODUCER><<<dim3(static_cast<unsigned>(rows)), THREADS, 0,
                                                 stream>>>(x, x2, gamma, beta, eps, q, scale, cols);
}

template <int PRODUCER>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* x2, const __nv_bfloat16* gamma,
                   const __nv_bfloat16* beta, float eps, int8_t* q, float* scale,
                   long long rows, int cols, cudaStream_t stream) {
  const int chunks = (cols + SMALL_BLOCK * VEC - 1) / (SMALL_BLOCK * VEC);
  if (chunks == 1)
    launch_one<SMALL_BLOCK, 1, PRODUCER>(x, x2, gamma, beta, eps, q, scale, rows, cols, stream);
  else if (chunks == 2)
    launch_one<SMALL_BLOCK, 2, PRODUCER>(x, x2, gamma, beta, eps, q, scale, rows, cols, stream);
  else if (chunks <= 4)
    launch_one<SMALL_BLOCK, 4, PRODUCER>(x, x2, gamma, beta, eps, q, scale, rows, cols, stream);
  else if (chunks <= MAX_CHUNKS)
    launch_one<SMALL_BLOCK, MAX_CHUNKS, PRODUCER>(x, x2, gamma, beta, eps, q, scale, rows, cols,
                                                  stream);
  else if (cols <= LARGE_BLOCK * VEC * MAX_CHUNKS)
    launch_one<LARGE_BLOCK, MAX_CHUNKS, PRODUCER>(x, x2, gamma, beta, eps, q, scale, rows, cols,
                                                  stream);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, else the cudaError_t of the failed launch. Shapes,
// dtypes, contiguity and alignment are checked by the Python wrapper
// (aigv_assessor_torch/ops/quant_fuse.py).
int aigv_quant_rows_fwd(int producer, const void* x, const void* x2, const void* gamma,
                        const void* beta, float eps, void* q, void* scale, long long rows,
                        int cols, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || cols <= 0 || cols % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* in = static_cast<const __nv_bfloat16*>(x);
  const auto* in2 = static_cast<const __nv_bfloat16*>(x2);
  const auto* g = static_cast<const __nv_bfloat16*>(gamma);
  const auto* b = static_cast<const __nv_bfloat16*>(beta);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(scale);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (producer) {
    case kIdentity:
      err = launch<kIdentity>(in, in2, g, b, eps, qo, so, rows, cols, st);
      break;
    case kLayerNorm:
      if (g == nullptr || b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      err = launch<kLayerNorm>(in, in2, g, b, eps, qo, so, rows, cols, st);
      break;
    case kGeluTanh:
      err = launch<kGeluTanh>(in, in2, g, b, eps, qo, so, rows, cols, st);
      break;
    case kRmsNorm:
      if (g == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      err = launch<kRmsNorm>(in, in2, g, b, eps, qo, so, rows, cols, st);
      break;
    case kSiluMul:
      if (in2 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      err = launch<kSiluMul>(in, in2, g, b, eps, qo, so, rows, cols, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
