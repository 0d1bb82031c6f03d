// Flash-attention forward for sm_90a, with two entry points over one kernel.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// aigv_assessor_tpu/ops/pallas_attention.py as both of its callers reach it:
//
// - `aigv_flash_attn_qkv_fwd`: off one fused head-major qkv array
//   (`flash_attention_qkv` -> `_fwd_qkv`), in the forms the scoring and
//   training paths run: bf16 output either head-major [B, Hq, S, D] (`bhsd`)
//   or as the dense rows [B, S, Hq*D] an out-projection reads (`bsd`, the
//   Pallas kernel's `dense_out`), and optionally the per-row logsumexp that
//   the backward kernels (flash_attn_bwd.cu) read (`with_lse`).
// - `aigv_flash_attn_fwd`: on three separate tensors (`flash_attention` ->
//   `_fwd`), q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D] (`bshd`) or
//   head-major (`bhsd`), which the weight-only decoder and the QK-normalized
//   ViT run, with the logsumexp when the call is differentiated (`_flash_fwd`
//   -> `_fwd(with_lse=True)`, the form the three-tensor backward in
//   flash_attn_bwd.cu reads). Sq and Skv may differ when not causal.
//
//   q, k, v  bf16, each read through its own strides (batch, head, row; D
//        contiguous), so slices and permuted views of a projection output
//        need no copy. The fused entry passes three pointers into the one
//        array, heads ordered [q | k | v]. q head h reads kv head h / G,
//        G = Hq / Hkv.
//   out  bf16, written through its strides (batch, head, row; D
//        contiguous): [B, Hq, Sq, D] for `bhsd`, [B, Sq, Hq*D] for `bsd` and
//        `bshd`. The layouts differ only in the store addresses.
//   lse  fp32 [B, Hq, Sq] contiguous or null: log(sum_k exp(scale * q.k))
//        over the unmasked keys, natural-log units; -inf for a row with no
//        valid key (its output row is 0). Storing it changes nothing in `out`.
//   Keys at or beyond kv_valid (<= Skv) are masked (the ViT pads 1025 tokens
//   to 1032 and the tail rows hold evolved values, not zeros); `causal`
//   (Sq == Skv) masks keys after the query. The ragged edges of Sq and Skv
//   are masked here; nothing is padded.
//
// Design. One block of 4 warps per (64-row q tile, q head, batch). Each warp
// owns 16 q rows, keeps its Q fragments in registers and loops over 64-key
// K/V tiles staged in shared memory. S = Q K^T and O += P V run on the
// tensor cores as mma.sync m16n8k16 bf16 with fp32 accumulation. The
// softmax is online, in base 2 (scale * log2(e) folded into the scores),
// with fp32 running max m and sum l per row; P is rounded to bf16 before
// the PV product, as the Pallas kernel does. Causal blocks stop at the
// diagonal tile; only tiles that cross the diagonal, kv_valid or S pay for
// the element mask. K/V rows at or beyond kv_valid are zero-filled in shared
// memory, so a non-finite garbage tail cannot reach the output through 0*inf.
//
// What bounds it. At the scoring shapes attention is compute-bound: the ViT
// (B=32, H=16, S=1032, D=64) does 4*B*H*S^2*D = 0.14 TFLOP per layer against
// 0.27 GB of qkv and output (~520 FLOP/byte); the LLM (B=4, Hq=16, Hkv=8,
// S=2113, D=128, causal) 0.07 TFLOP against 0.10 GB (~700 FLOP/byte). Both
// are above the H100's ~295 bf16 FLOP/byte, so the limit is the tensor-core rate,
// and this version reaches only a part of it: mma.sync instead of wgmma, and
// no overlap of the next tile's loads with the current tile's math. Fragments
// come from shared memory through ldmatrix (mma_fragments.cuh); rows there
// are padded by 8 elements so that its 16-byte row reads hit distinct banks.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_fragments.cuh"

namespace {

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NWARPS = BQ / 16;  // one warp per 16 q rows
constexpr int NTHREADS = NWARPS * 32;

// strides of one tensor in elements; D is contiguous
struct Strides {
  long long batch, head, row;
};

// D = 64 fits 128 registers and D = 128 fits 170, so four and three blocks
// share an SM: hold the compiler to that
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 4 : 3)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ vals, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int kv_valid, int hq, int hkv,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale_log2) {
  constexpr int LD = D + PAD;     // smem row stride, elements
  constexpr int CHUNKS = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const __nv_bfloat16* qp = q + b * qs.batch + h * qs.head;
  const __nv_bfloat16* kp = k + b * ks.batch + kvh * ks.head;
  const __nv_bfloat16* vp = vals + b * vs.batch + kvh * vs.head;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2;  // fragment row group 0..7
  const int tq = lane & 3;   // thread within the group 0..3

  for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) v = *reinterpret_cast<const uint4*>(qp + (q0 + r) * qs.row + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = v;
  }
  __syncthreads();

  // A fragments of this warp's 16 q rows
  const int wr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qf[kk], sQ, wr, kk * 16, lane);

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  // per thread: rows r0 = q0 + wr + gr (elements 0,1) and r0 + 8 (2,3)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns
  const int r0 = q0 + wr + gr;

  int n_tiles = (kv_valid + BK - 1) / BK;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < kv_valid) {
        kv = *reinterpret_cast<const uint4*>(kp + (k0 + r) * ks.row + c);
        vv = *reinterpret_cast<const uint4*>(vp + (k0 + r) * vs.row + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vv;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x BK keys per warp, as BK/8 n-tiles of 8 keys, two
    // tiles per fragment load
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; nt += 2) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      s[nt + 1][0] = s[nt + 1][1] = s[nt + 1][2] = s[nt + 1][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        load_b_rows<LD>(bk, sK, nt * 8, kk * 16, lane);
        mma_16816(s[nt], qf[kk], bk[0], bk[1]);
        mma_16816(s[nt + 1], qf[kk], bk[2], bk[3]);
      }
    }

    const bool need_mask =
        k0 + BK > kv_valid || (CAUSAL && k0 + BK - 1 > q0 + wr);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[nt][e] * scale_log2;
        if (need_mask) {
          const int col = k0 + nt * 8 + tq * 2 + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          if (col >= kv_valid || (CAUSAL && col > row)) v = -INFINITY;
        }
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2], mref[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four threads of a row group hold one row's columns
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no valid key yet keeps m = -inf; exponentiate against 0
      mref[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = exp2f(m[i] - mref[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mref[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V over BK/16 steps of 16 keys. The accumulator layout of two
    // neighbouring 8-key score tiles is the A fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        load_b_cols<LD>(bv, sV, kk * 16, dt * 8, lane);
        mma_16816(o[dt], pf, bv[0], bv[1]);
        mma_16816(o[dt + 1], pf, bv[2], bv[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  __nv_bfloat16* op = out + b * os.batch + h * os.head;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(op + r0 * os.row + col) =
          pack_f32(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(op + (r0 + 8) * os.row + col) =
          pack_f32(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
  if (lse != nullptr && tq == 0) {
    // m is in base-2 units of the scaled scores; l = 0 and m = -inf give -inf
    float* lp = lse + (static_cast<long long>(b) * hq + h) * Sq;
    if (r0 < Sq) lp[r0] = (m[0] + log2f(l[0])) * 0.6931471805599453f;
    if (r0 + 8 < Sq) lp[r0 + 8] = (m[1] + log2f(l[1])) * 0.6931471805599453f;
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* out, float* lse, int B, int hq, int hkv, int Sq, int kv_valid,
                   Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
                   cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  // D=128 needs 52 KB, above the 48 KB a block gets without opting in
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, hq, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(q, k, v, out, lse, Sq, kv_valid, hq, hkv, qs, ks, vs,
                                           os, scale_log2);
  return cudaGetLastError();
}

// Checks what the kernel relies on and picks the instantiation.
int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
             __nv_bfloat16* out, float* lse, int B, int hq, int hkv, int Sq, int Skv, int D,
             int kv_valid, int causal, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || hkv <= 0 || hq % hkv != 0 || kv_valid <= 0 ||
      kv_valid > Skv || (causal && Sq != Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 65535 || hq > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err;
  if (D == 64)
    err = causal ? launch<64, true>(q, k, v, out, lse, B, hq, hkv, Sq, kv_valid, qs, ks, vs, os, scale_log2, st)
                 : launch<64, false>(q, k, v, out, lse, B, hq, hkv, Sq, kv_valid, qs, ks, vs, os, scale_log2, st);
  else if (D == 128)
    err = causal ? launch<128, true>(q, k, v, out, lse, B, hq, hkv, Sq, kv_valid, qs, ks, vs, os, scale_log2, st)
                 : launch<128, false>(q, k, v, out, lse, B, hq, hkv, Sq, kv_valid, qs, ks, vs, os, scale_log2, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Both return 0 on success, else the cudaError_t of the failed launch. Shapes,
// dtypes, strides and alignment are checked by the Python wrappers. Strides
// are in elements, for (batch, head, row). lse is null (no logsumexp) or a
// contiguous fp32 [B, hq, Sq].

// The fused array: sb/sh/ss are qkv's strides and ob/oh/os the output's.
int aigv_flash_attn_qkv_fwd(const void* qkv, void* out, void* lse, int B, int hq, int hkv, int S,
                            int D, int kv_valid, int causal, long long sb, long long sh,
                            long long ss, long long ob, long long oh, long long os,
                            float scale, void* stream) {
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const Strides in{sb, sh, ss};
  return dispatch(q, q + hq * sh, q + (hq + hkv) * sh, static_cast<__nv_bfloat16*>(out),
                  static_cast<float*>(lse), B, hq, hkv, S, S, D, kv_valid, causal, in, in, in,
                  Strides{ob, oh, os}, scale, stream);
}

// Three tensors: strides[0..2] are q's, [3..5] k's, [6..8] v's, [9..11] the
// output's.
int aigv_flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                        int hq, int hkv, int Sq, int Skv, int D, int kv_valid, int causal,
                        const long long* strides, float scale, void* stream) {
  const long long* s = strides;
  return dispatch(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
                  static_cast<float*>(lse), B, hq, hkv, Sq, Skv, D, kv_valid, causal,
                  Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
                  Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]}, scale, stream);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
