// Single-token decode attention for sm_90a: one query token per sample
// against the read-only KV cache, over each sample's own window of rows.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// aigv_assessor_tpu/ops/decode_attention.py (through `decode_attention`).
//
//   q      bf16 [B, Hq, D]          strides (q_sb, q_sh, 1)
//   k, v   bf16 [B, max_len, Hkv, D] strides (sb, sr, sh, 1): the model's
//          cache layout, read in place
//   starts int32 [B], end int32 [1], both in device memory: sample b attends
//          rows [starts[b], end) and the kernel loads no other row
//   out    bf16 [B, Hq, D]  softmax(q k^T * scale) v over the window, or 0
//          for an empty window
//   m, l   fp32 [B, Hq]     the window's row maximum of the scaled scores
//          (-1e30 for an empty window) and the sum of exp(score - m), so that
//          the caller can fold the current token in afterwards
//   Query heads h*G .. (h+1)*G-1 share kv head h (G = Hq / Hkv). D is 64 or
//   128.
//
// What bounds it. Every K and V row of the window is read once and used for
// G dot products of D terms: 2*G operations per byte at most, so the bytes
// bound it, (end - start_b) * Hkv * D * 2 * 2 per sample. The tensor cores
// have nothing to do. What counts is to keep enough 16-byte loads in flight
// on enough SMs, and to read nothing outside the window.
//
// Design. The TPU kernel walks a (B, max_len / BLK) grid in sequence with a
// running state in scratch memory; here nothing carries over between blocks,
// so the window is cut instead:
//
// - `decode_attention_partial`: one block of 8 warps per (kv head, sample,
//   split). A split is a contiguous 1/nsplit of the sample's window, computed
//   in the kernel from starts[b] and end; the wrapper picks nsplit from the
//   capacity and the batch so that somewhat more blocks than SMs exist
//   whatever the batch. D/8 lanes share a row, each loading 16 bytes of K
//   and of V; a warp takes 32/(D/8) rows at a time and UNROLL such groups per
//   step, so that all loads of a step are in flight before the first is used.
//   The G scores of a row are reduced over its lanes by shuffles. Every lane
//   group keeps its own fp32 online-softmax state (m, l, acc[G][8]), rescaled
//   once per step; the groups of a warp are merged by shuffles and the warps
//   through shared memory. q sits in registers. The block writes its
//   unnormalised acc and its (m, l) to scratch.
// - `decode_attention_combine`: one block per (query head, sample) merges
//   the nsplit partial states, normalises and writes out, m and l.
//
// Against the TPU kernel's numbers. Kept: scores scaled by D^-0.5 in fp32
// after the fp32 dot product; masked rows contribute nothing (they are never
// loaded, where the TPU kernel sets them to -1e30); out = acc / l, or 0 where
// l == 0; m and l of the window only. Changed: p stays fp32 for p * v, where
// the TPU kernel rounds p to the cache dtype to feed its matrix unit; there
// is no matrix unit in this product, and the fp32 p is the more exact. The
// difference to a version that rounds p is below the bf16 rounding of `out`.
// exp is __expf (ex2.approx): a few fp32 ulps on m - m_new <= 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Merge the online-softmax state (m_o, l_o, acc_o) into (m, l, acc).
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[8], float m_o,
                                            float l_o, const float (&acc_o)[8]) {
  const float m_new = fmaxf(m, m_o);
  const float a = __expf(m - m_new), b = __expf(m_o - m_new);
  l = l * a + l_o * b;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = acc[j] * a + acc_o[j] * b;
  m = m_new;
}

template <int D, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_partial(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ starts,
                         const int* __restrict__ end_ptr, float* __restrict__ part_acc,
                         float* __restrict__ part_m, float* __restrict__ part_l, int hq, int hkv,
                         int max_len, int nsplit, long long q_sb, long long q_sh, long long k_sb,
                         long long k_sr, long long k_sh, long long v_sb, long long v_sr,
                         long long v_sh, float scale) {
  constexpr int LPR = D / 8;     // lanes per row, 16 bytes each
  constexpr int RPW = 32 / LPR;  // rows a warp takes at a time
  constexpr int UNROLL = G >= 4 ? 2 : 4;
  __shared__ float s_acc[NWARPS][G][D];
  __shared__ float s_m[NWARPS][G], s_l[NWARPS][G];

  const int group = hq / hkv;    // query heads per kv head
  const int chunks = group / G;  // blocks per kv head, G query heads each
  const int h = blockIdx.x / chunks;
  const int head0 = h * group + (blockIdx.x % chunks) * G;
  const int b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPR, col = (lane % LPR) * 8;

  // this block's rows [lo, hi) of the sample's window [start, end)
  const int end = min(*end_ptr, max_len);
  const int start = max(starts[b], 0);
  const int n = max(end - start, 0);
  const int per = (n + nsplit - 1) / nsplit;
  const int lo = start + z * per;
  const int hi = min(lo + per, end);

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
    unpack8(*reinterpret_cast<const uint4*>(q + b * q_sb + (head0 + g) * q_sh + col), qf[g]);

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh + col;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh + col;
  constexpr int STEP = NWARPS * RPW;  // rows the block takes at a time
  // the bound is uniform over a warp, so every lane reaches the shuffles
  for (int r0 = lo + warp * RPW; r0 < hi; r0 += STEP * UNROLL) {
    uint4 kk[UNROLL], vv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = r0 + u * STEP + sub;
      kk[u] = vv[u] = make_uint4(0, 0, 0, 0);
      if (row < hi) {
        kk[u] = *reinterpret_cast<const uint4*>(kb + row * k_sr);
        vv[u] = *reinterpret_cast<const uint4*>(vb + row * v_sr);
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[8];
      unpack8(kk[u], kf);
      const bool ok = r0 + u * STEP + sub < hi;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qf[g][j], kf[j], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = ok ? d * scale : NEG;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) m_new = fmaxf(m_new, s[u][g]);
      const float alpha = __expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[8];
      unpack8(vv[u], vf);
      const bool ok = r0 + u * STEP + sub < hi;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ok ? __expf(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
      }
    }
  }

  // the lane groups of a warp hold states of different rows: merge them
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      float acc_o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_o[j] = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
      merge_state(m[g], l[g], acc[g], m_o, l_o, acc_o);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s_acc[warp][g][col + j] = acc[g][j];
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // the warps' states into one, written unnormalised
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float m_all = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_all = fmaxf(m_all, s_m[w][g]);
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float e = __expf(s_m[w][g] - m_all);
      l_all += s_l[w][g] * e;
      a += s_acc[w][g][d] * e;
    }
    const long long slot = (static_cast<long long>(b) * hq + head0 + g) * nsplit + z;
    part_acc[slot * D + d] = a;
    if (d == 0) {
      part_m[slot] = m_all;
      part_l[slot] = l_all;
    }
  }
}

// grid (Hq, B), D threads: the nsplit partial states of one query head
template <int D>
__global__ void __launch_bounds__(D)
decode_attention_combine(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                         const float* __restrict__ part_l, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out, int hq, int nsplit) {
  const long long head = static_cast<long long>(blockIdx.y) * hq + blockIdx.x;
  const int d = threadIdx.x;
  float m = NEG;
  for (int z = 0; z < nsplit; ++z) m = fmaxf(m, part_m[head * nsplit + z]);
  float l = 0.f, a = 0.f;
  for (int z = 0; z < nsplit; ++z) {
    const float e = __expf(part_m[head * nsplit + z] - m);
    l += part_l[head * nsplit + z] * e;
    a += part_acc[(head * nsplit + z) * D + d] * e;
  }
  out[head * D + d] = __float2bfloat16_rn(l > 0.f ? a / l : 0.f);
  if (d == 0) {
    m_out[head] = m;
    l_out[head] = l;
  }
}

struct Args {
  const void *q, *k, *v, *starts, *end;
  void *part_acc, *part_m, *part_l, *out, *m, *l;
  int B, hq, hkv, max_len, nsplit;
  long long q_sb, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh;
  float scale;
  cudaStream_t stream;
};

template <int D, int G>
int launch(const Args& a) {
  const dim3 grid(a.hkv * ((a.hq / a.hkv) / G), a.B, a.nsplit);
  decode_attention_partial<D, G><<<grid, NTHREADS, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const int*>(a.starts),
      static_cast<const int*>(a.end), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l), a.hq, a.hkv, a.max_len,
      a.nsplit, a.q_sb, a.q_sh, a.k_sb, a.k_sr, a.k_sh, a.v_sb, a.v_sr, a.v_sh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_combine<D><<<dim3(a.hq, a.B), D, 0, a.stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_m),
      static_cast<const float*>(a.part_l), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.hq, a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

// G query heads per block: the largest of 8, 4, 2, 1 that divides the group
template <int D>
int launch_d(const Args& a) {
  const int group = a.hq / a.hkv;
  if (group % 8 == 0) return launch<D, 8>(a);
  if (group % 4 == 0) return launch<D, 4>(a);
  if (group % 2 == 0) return launch<D, 2>(a);
  return launch<D, 1>(a);
}

}  // namespace

extern "C" {

// Returns 0 on success, else the cudaError_t of the failed launch. Dtypes,
// shapes, alignment and devices are checked by the Python wrapper. Strides
// are in elements. part_acc [B, Hq, nsplit, D], part_m and part_l
// [B, Hq, nsplit] are fp32 scratch that the wrapper allocates.
int aigv_decode_attention(const void* q, const void* k, const void* v, const void* starts,
                          const void* end, void* part_acc, void* part_m, void* part_l, void* out,
                          void* m, void* l, int B, int hq, int hkv, int max_len, int D, int nsplit,
                          long long q_sb, long long q_sh, long long k_sb, long long k_sr,
                          long long k_sh, long long v_sb, long long v_sr, long long v_sh,
                          float scale, void* stream) {
  if (B <= 0 || hkv <= 0 || hq <= 0 || hq % hkv || max_len <= 0 || nsplit <= 0 || B > 65535 ||
      nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,   starts,  end,    part_acc, part_m, part_l, out,  m,    l,
               B,  hq, hkv, max_len, nsplit, q_sb,     q_sh,   k_sb,   k_sr, k_sh, v_sb,
               v_sr, v_sh, scale, static_cast<cudaStream_t>(stream)};
  if (D == 128) return launch_d<128>(a);
  if (D == 64) return launch_d<64>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
