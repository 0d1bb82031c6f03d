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
// as `jax.lax.logistic`; rint of the IEEE quotient y / s, rounding half to
// even (below: computed without the division, with the same result); and
// every product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction), as the eager plain version rounds them. The row sums are
// taken in another order than the plain version's, and the GELU's tanh is
// computed another way (at `gelu_tanh`), so where y / s lies within an ulp
// of a half an int8 value can differ by one.
//
// The quotient. rint(y / s) with an IEEE division costs a reciprocal on the
// special-function unit and a Newton step per element; the elements are
// bound by instruction issue, not bytes (K4b: ~50 instructions each). So
// t = y * inv, with inv = 1/s correctly rounded once per row, stands in for
// q = fl(y / s), and rint(t) is taken when t is farther than 2^-15 from every
// half-integer. Proof that rint(t) == rint(q) there: |y| <= absmax and
// s = fl(max(absmax, 1e-8) / 127), so |y / s| <= 127 (1 + 2^-24); with
// u = 2^-24, inv = (1/s)(1 + a), t = y inv (1 + b), q = (y/s)(1 + c),
// |a|, |b|, |c| <= u, hence |t - q| <= |y/s| (3u + u^2) < 2.3e-5 < 2^-15.
// No half-integer lies within 2^-15 of t, so none lies between t and q, and
// q is no tie: both round to the same integer. Elsewhere (about 6e-5 of the
// elements, and any NaN) the exact rintf(__fdiv_rn(y, s)) runs, clipped as
// before. The rounding itself is t + 1.5 * 2^23 (round to nearest even at
// unit spacing, |t| < 2^22), whose low byte is the int8 value in two's
// complement: no conversion instruction, also a quarter-rate pipe. On the
// fast path |rint(t)| <= 127, so the clip is void. The result is bit for bit
// that of the division for every input (tests/test_torch_decode_fused.py
// checks a float32 model of it).
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
// latency is hidden by the blocks an SM holds at once. But the per-element
// math can bind before the bytes: on an H100 the identity producer at K4b's
// shape runs at 89% of the byte bound and the GELU with libdevice's tanhf
// and the IEEE division at 48%, so the quotient and the tanh above are
// written for instruction count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;  // bf16 values per 16-byte load
constexpr int MAX_CHUNKS = 8;  // 16-byte vectors a thread holds
constexpr int SMALL_BLOCK = 128, LARGE_BLOCK = 256;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23
constexpr float kFastLimit = 0.5f - 0.000030517578125f;  // 0.5 - 2^-15

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

// The division's answer, for the few elements near a half-integer; out of
// line, so that the unrolled per-element code stays small
__device__ __noinline__ uint32_t quant_byte_exact(float y, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(r)));
}

// int8 rint(y / s), clipped to [-127, 127], in the low byte (see "The
// quotient" above; inv = __frcp_rn(s))
__device__ __forceinline__ uint32_t quant_byte(float y, float s, float inv) {
  const float t = __fmul_rn(y, inv);
  const float big = __fadd_rn(t, kRoundMagic);
  if (fabsf(__fsub_rn(t, __fsub_rn(big, kRoundMagic))) < kFastLimit) return __float_as_uint(big);
  return quant_byte_exact(y, s);
}

// 0.5 x (1 + tanh(u)) = x / (1 + e^(-2u)), u = sqrt(2/pi) (x + 0.044715 x^3),
// with e^(-2u) = 2^(-2 u log2(e)) on ex2.approx and the quotient on
// rcp.approx: two special-function instructions and no branch, where
// libdevice's tanhf branches on |u| and took a third of K4b's time. Over
// every finite bf16 x its largest error is 9.3 fp32 ulps where |y| >= 1e-3
// (JAX's order with libdevice's tanhf: 372, from the cancellation in 1 + t
// for negative x); below that, where x < -5 and y is a few 1e-9 * x or
// less, it keeps the tail that 1 + tanh(u) rounds to 0
// (tools/quant_fuse_ab.py measures both on the card). Against the plain
// version it flips 2.7e-6 of K4b's int8 values.
__device__ __forceinline__ float gelu_tanh(float v) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, v), v), v);
  const float u = __fmul_rn(kSqrt2OverPi, __fadd_rn(v, cube));
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(__fmul_rn(-2.8853900817779268f, u)));
  return __fdividef(v, __fadd_rn(1.0f, e));
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
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[c][e] = gelu_tanh(y[c][e]);
  }

  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (!valid[c]) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(y[c][e]));
  }
  const float s = __fdiv_rn(fmaxf(block_max<WARPS>(amax, red), 1e-8f), 127.0f);
  const float inv = __frcp_rn(s);

  int8_t* qr = q + row * cols;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (!valid[c]) continue;
    uint32_t b[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) b[e] = quant_byte(y[c][e], s, inv);
    // the low bytes, four to a word
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = __byte_perm(__byte_perm(b[4 * h], b[4 * h + 1], 0x0040),
                         __byte_perm(b[4 * h + 2], b[4 * h + 3], 0x0040), 0x5410);
    *reinterpret_cast<uint2*>(qr + c * ROW_TILE + threadIdx.x * VEC) = make_uint2(w[0], w[1]);
  }
  if (threadIdx.x == 0) scale[row] = s;
}

// The GELU producer alone, elementwise: its error against the exact
// function over every bf16 input, measured on the card
__global__ void gelu_values_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                                   long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = gelu_tanh(__bfloat162float(x[i]));
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

// y fp32 [n] = the GELU producer of x bf16 [n], as the fused kernel computes
// it; a measuring aid, on no model path.
int aigv_gelu_values(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gelu_values_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
