// Flash-attention backward for sm_90a, over separate q, k, v tensors, with
// two pairs of entry points over one pair of kernels.
//
// Replaces the two Pallas TPU kernels of `_bwd` in
// aigv_assessor_tpu/ops/pallas_attention.py:
//   `_bwd_dq_kernel`   -> flash_bwd_dq_kernel   (dq)
//   `_bwd_dkv_kernel`  -> flash_bwd_dkv_kernel  (dk and dv)
// as both of their callers reach them:
// - `aigv_flash_attn_qkv_bwd_dq` / `_dkv`: off one fused head-major qkv array
//   (`flash_attention_qkv`'s custom_vjp, `_flash_qkv_bwd`), gradients into
//   one dqkv array of the same layout: K3a / K3b, which stage-2 training runs
//   in both towers of InternVL2-2B and in the decoder of InternVL2-26B.
// - `aigv_flash_attn_bwd_dq` / `_dkv`: on three separate tensors
//   (`flash_attention`'s custom_vjp, `_flash_bwd`), `bshd` or `bhsd`, Sq and
//   Skv free when not causal: K2's backward, which the QK-normalized ViT of
//   InternVL2-26B runs in training.
//
//   q     [B, Hq, Sq, D] bf16 (or any layout): each of q, k, v, dout, dq, dk
//         and dv is read or written through its own (batch, head, row)
//         strides, D contiguous, so slices and permuted views of a projection
//         output need no copy. The fused entries pass pointers into one
//         array, heads ordered [q | k | v]. q head h reads kv head h / G,
//         G = Hq / Hkv.
//   k, v  [B, Hkv, Skv, D] bf16.
//   dout  [B, Hq, Sq, D] bf16.
//   lse   [B, Hq, Sq] fp32 contiguous, the forward's logsumexp in natural-log
//         units; -inf marks a row with no valid key, whose p is 0 here.
//   delta [B, Hq, Sq] fp32 contiguous, rowsum(dout * out), computed by the
//         caller as the JAX `_bwd` computes it outside its kernels.
//   dq    [B, Hq, Sq, D] bf16, written by the dq kernel, every row below Sq.
//   dk, dv [B, Hkv, Skv, D] bf16, written by the dk/dv kernel, every row
//         below Skv (rows of keys at or beyond kv_valid get exact zeros), so
//         the caller allocates them uninitialised.
//
// With c = scale * log2(e):  p  = exp2(c * q.k - lse * log2(e)), 0 where the
// key is at or beyond kv_valid or (causal, Sq == Skv) after the query;
//   dp = do . v       ds = p * (dp - delta)
//   dq = scale * ds k     dk = scale * ds^T q     dv = p^T do
// Query rows at or beyond Sq are zero-filled and their lse taken as +inf, so
// the padded rows of a q tile contribute nothing.
//
// Design. Both kernels run 4 warps on mma.sync m16n8k16 bf16 with fp32
// accumulation, tiles of 64 rows by 64 keys, rows in shared memory padded by
// 8 elements, as the forward does. The backward needs no running max (lse is
// given), so a tile is processed in steps of 16 keys (dq) or 16 query rows
// (dk/dv): the scores and dp of one step live in 16 registers, and the step's
// p / ds become the A fragment of the next product without leaving
// registers.
//   dq:    one block per (64-row q tile, q head, batch); a warp owns 16 q rows
//          and keeps their Q and dO fragments and the dq accumulator in
//          registers while K/V tiles stream through shared memory. Causal
//          blocks stop at the diagonal and are scheduled heaviest first.
//   dk/dv: one block per (64-key tile, KV head, batch); a warp owns 16 keys.
//          It computes the transposed scores S^T = K Q^T and dP^T = V dO^T, so
//          the keys are the accumulator rows, and loops over the G query
//          heads of its group and their q tiles, accumulating dk and dv in
//          fp32 registers. No per-query-head fp32 temporaries, no atomics, and
//          the group sum has a fixed order. (The Pallas kernel emits dk/dv
//          per query head in fp32 and sums the group outside, `:637-638`.)
//          Causal blocks start at the diagonal.
// K/V rows at or beyond kv_valid are zero-filled in shared memory, so a
// garbage tail cannot reach a sum through 0 * inf, and their p is masked to
// exactly 0: dk/dv rows of masked keys are exactly 0.
//
// Numerics. The Pallas kernels keep do, v, p and ds in fp32 for dp, dv and
// dk. mma.sync takes bf16 operands, so here p is rounded to bf16 before
// p^T do and ds before ds k and ds^T q; do and v are bf16 as given. The plain
// versions (`plain_flash_attention_bwd`, `plain_attention_qkv_bwd`) round at
// the same two places.
//
// What bounds them. Operations: dq is three products (6*B*H*Sq*Skv*D FLOP,
// half under the causal mask), dk/dv four (8*B*H*Sq*Skv*D), against a few
// hundred MB of tiles, far above the H100's ~295 bf16 FLOP/byte. This version
// reaches a part of the tensor-core rate only: mma.sync rather than wgmma,
// and no overlap of loads with math. Fragments come from shared memory
// through ldmatrix, transposed on the way in for the k-major B operands
// (mma_fragments.cuh). At D = 128 the dk/dv kernel reloads its K and V
// fragments from shared memory every step, because dk, dv, K and V fragments
// together would not fit the register file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_fragments.cuh"

namespace {

constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int NWARPS = 4;        // 16 rows (dq) or 16 keys (dk/dv) per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// strides of one tensor in elements; D is contiguous
struct Strides {
  long long batch, head, row;
};

// the shapes, strides and scale both kernels read (the pointers go as
// separate __restrict__ parameters, so that the compiler may reorder the tile
// loads around the shared-memory stores)
struct Dims {
  int hq, hkv, Sq, Skv, kv_valid;
  Strides qs, ks, vs, os, dqs, dks, dvs;  // os: dout's
  float scale;
};

// everything a launch takes
struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Dims d;
};

#define BWD_PARAMS                                                                          \
  const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,                \
      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,         \
      const float* __restrict__ lse, const float* __restrict__ delta,                      \
      __nv_bfloat16* __restrict__ dqg, __nv_bfloat16* __restrict__ dkg,                    \
      __nv_bfloat16* __restrict__ dvg, const Dims a

// Copy 64 rows of D bf16, global rows [g0, g0 + 64), into a padded smem
// tile; rows at or beyond `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* __restrict__ tile,
                                           const __nv_bfloat16* __restrict__ src,
                                           int row_stride, int g0, int limit, int tid) {
  constexpr int LD = D + PAD;
  constexpr int CHUNKS = D / 8;
  for (int i = tid; i < 64 * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (g0 + r < limit) v = *reinterpret_cast<const uint4*>(src + (g0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(tile + r * LD + c) = v;
  }
}

// lse in base-2 units for the exponent; +inf where p must be 0 (a row at or
// beyond Sq, or a row the forward found no valid key for)
__device__ __forceinline__ float lse_to_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * LOG2E;
}

// ------------------------------------------------------------------- dq ---

// D = 64 fits 128 registers, so four blocks share an SM: hold the compiler to it
template <int D, bool CAUSAL, bool SHARED>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 4 : 1) flash_bwd_dq_kernel(BWD_PARAMS) {
  // shared strides: k and v are read through q's
  const Strides& ks = SHARED ? a.qs : a.ks;
  const Strides& vs = SHARED ? a.qs : a.vs;
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BK * LD;

  // causal: the last q tiles have the most key tiles; start them first
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int Sq = a.Sq, kv_valid = a.kv_valid;
  const __nv_bfloat16* qp = q + b * a.qs.batch + h * a.qs.head;
  const __nv_bfloat16* kp = k + b * ks.batch + kvh * ks.head;
  const __nv_bfloat16* vp = v + b * vs.batch + kvh * vs.head;
  const __nv_bfloat16* dop = dout + b * a.os.batch + h * a.os.head;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2;  // fragment row group 0..7
  const int tq = lane & 3;   // thread within the group 0..3
  const int wr = warp * 16;
  const float scale_log2 = a.scale * LOG2E;

  // Q and dO go through the K/V buffers once, into register fragments
  stage_tile<D>(sK, qp, static_cast<int>(a.qs.row), q0, Sq, tid);
  stage_tile<D>(sV, dop, static_cast<int>(a.os.row), q0, Sq, tid);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<LD>(qf[kk], sK, wr, kk * 16, lane);
    load_a<LD>(dof[kk], sV, wr, kk * 16, lane);
  }

  // per thread: rows r0 = q0 + wr + gr (elements 0,1) and r0 + 8 (2,3)
  const int r0 = q0 + wr + gr;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i * 8;
    const long long at = (static_cast<long long>(b) * a.hq + h) * Sq + r;
    lse2[i] = r < Sq ? lse_to_log2(lse[at]) : INFINITY;
    dl[i] = r < Sq ? delta[at] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  int n_tiles = (kv_valid + BK - 1) / BK;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile (or Q/dO)
    stage_tile<D>(sK, kp, static_cast<int>(ks.row), k0, kv_valid, tid);
    stage_tile<D>(sV, vp, static_cast<int>(vs.row), k0, kv_valid, tid);
    __syncthreads();

    const bool need_mask = k0 + BK > kv_valid || (CAUSAL && k0 + BK - 1 > q0 + wr);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {  // 16 keys per step
      float s[2][4], dp[2][4];  // two 8-key tiles
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4], bv[4];
        load_b_rows<LD>(bk, sK, kc * 16, kk * 16, lane);
        load_b_rows<LD>(bv, sV, kc * 16, kk * 16, lane);
        mma_16816(s[0], qf[kk], bk[0], bk[1]);  // q . k
        mma_16816(s[1], qf[kk], bk[2], bk[3]);
        mma_16816(dp[0], dof[kk], bv[0], bv[1]);  // do . v
        mma_16816(dp[1], dof[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[j][e] * scale_log2 - lse2[e >> 1]);
          if (need_mask) {
            const int col = k0 + kc * 16 + j * 8 + tq * 2 + (e & 1);
            const int row = r0 + (e >> 1) * 8;
            if (col >= kv_valid || (CAUSAL && col > row)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // ds
        }
      }
      // the accumulator layout of the two 8-key tiles is the A fragment of
      // one 16-key step of ds k
      const uint32_t dsf[4] = {pack_f32(s[0][0], s[0][1]), pack_f32(s[0][2], s[0][3]),
                               pack_f32(s[1][0], s[1][1]), pack_f32(s[1][2], s[1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bk[4];
        load_b_cols<LD>(bk, sK, kc * 16, dt * 8, lane);
        mma_16816(dq[dt], dsf, bk[0], bk[1]);
        mma_16816(dq[dt + 1], dsf, bk[2], bk[3]);
      }
    }
  }

  __nv_bfloat16* gp = dqg + b * a.dqs.batch + h * a.dqs.head;
  const int gs = static_cast<int>(a.dqs.row);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(gp + r0 * gs + col) =
          pack_f32(dq[dt][0] * a.scale, dq[dt][1] * a.scale);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(gp + (r0 + 8) * gs + col) =
          pack_f32(dq[dt][2] * a.scale, dq[dt][3] * a.scale);
  }
}

// ---------------------------------------------------------------- dk/dv ---

template <int D, bool CAUSAL, bool SHARED>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(BWD_PARAMS) {
  // shared strides: k and v are read through q's
  const Strides& ks = SHARED ? a.qs : a.ks;
  const Strides& vs = SHARED ? a.qs : a.vs;
  const Strides& dks = a.dks;
  const Strides& dvs = a.dvs;
  constexpr int LD = D + PAD;
  // K and V fragments stay in registers next to dk and dv only at D = 64
  constexpr bool KV_IN_REGS = D <= 64;
  constexpr int KVF = KV_IN_REGS ? D / 16 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BK * LD;
  __nv_bfloat16* sQ = sV + BK * LD;
  __nv_bfloat16* sdO = sQ + BQ * LD;
  float* sLse2 = reinterpret_cast<float*>(sdO + BQ * LD);
  float* sDelta = sLse2 + BQ;

  const int k0 = blockIdx.x * BK;  // causal: tile 0 is the heaviest and first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int Sq = a.Sq, kv_valid = a.kv_valid;
  const __nv_bfloat16* kp = k + b * ks.batch + kvh * ks.head;
  const __nv_bfloat16* vp = v + b * vs.batch + kvh * vs.head;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int wr = warp * 16;  // this warp's 16 keys within the tile
  const float scale_log2 = a.scale * LOG2E;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  // a tile of masked keys only does no work and stores zeros
  const int n_q_tiles = k0 < kv_valid ? (Sq + BQ - 1) / BQ : 0;
  const int first_q_tile = CAUSAL ? k0 / BQ : 0;

  stage_tile<D>(sK, kp, static_cast<int>(ks.row), k0, kv_valid, tid);
  stage_tile<D>(sV, vp, static_cast<int>(vs.row), k0, kv_valid, tid);
  __syncthreads();
  uint32_t kf[KVF][4], vf[KVF][4];
  if constexpr (KV_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KVF; ++kk) {
      load_a<LD>(kf[kk], sK, wr, kk * 16, lane);
      load_a<LD>(vf[kk], sV, wr, kk * 16, lane);
    }
  }

  // per thread: keys c0 = k0 + wr + gr (elements 0,1) and c0 + 8 (2,3)
  const int c0 = k0 + wr + gr;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const __nv_bfloat16* qp = q + b * a.qs.batch + h * a.qs.head;
    const __nv_bfloat16* dop = dout + b * a.os.batch + h * a.os.head;
    const long long stat = (static_cast<long long>(b) * a.hq + h) * Sq;
    for (int qt = first_q_tile; qt < n_q_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous q tile
      stage_tile<D>(sQ, qp, static_cast<int>(a.qs.row), q0, Sq, tid);
      stage_tile<D>(sdO, dop, static_cast<int>(a.os.row), q0, Sq, tid);
      if (tid < BQ) {
        const int r = q0 + tid;
        sLse2[tid] = r < Sq ? lse_to_log2(lse[stat + r]) : INFINITY;
        sDelta[tid] = r < Sq ? delta[stat + r] : 0.f;
      }
      __syncthreads();

      // keys after every row of the tile, or beyond kv_valid, need the mask
      const bool need_mask = k0 + BK > kv_valid || (CAUSAL && k0 + wr + 15 > q0);
#pragma unroll
      for (int rc = 0; rc < BQ / 16; ++rc) {  // 16 q rows per step
        // transposed scores: accumulator rows are keys, columns are q rows
        float st[2][4], dpt[2][4];  // two 8-row tiles
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
          dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t bq[4], bdo[4];
          load_b_rows<LD>(bq, sQ, rc * 16, kk * 16, lane);
          load_b_rows<LD>(bdo, sdO, rc * 16, kk * 16, lane);
          if constexpr (KV_IN_REGS) {
            mma_16816(st[0], kf[kk], bq[0], bq[1]);  // k . q
            mma_16816(st[1], kf[kk], bq[2], bq[3]);
            mma_16816(dpt[0], vf[kk], bdo[0], bdo[1]);  // v . do
            mma_16816(dpt[1], vf[kk], bdo[2], bdo[3]);
          } else {
            uint32_t ak[4], av[4];
            load_a<LD>(ak, sK, wr, kk * 16, lane);
            load_a<LD>(av, sV, wr, kk * 16, lane);
            mma_16816(st[0], ak, bq[0], bq[1]);
            mma_16816(st[1], ak, bq[2], bq[3]);
            mma_16816(dpt[0], av, bdo[0], bdo[1]);
            mma_16816(dpt[1], av, bdo[2], bdo[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = rc * 16 + j * 8 + tq * 2 + (e & 1);  // q row in the tile
            float p = exp2f(st[j][e] * scale_log2 - sLse2[rl]);
            if (need_mask) {
              const int col = c0 + (e >> 1) * 8;
              if (col >= kv_valid || (CAUSAL && col > q0 + rl)) p = 0.f;
            }
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - sDelta[rl]);  // ds
          }
        }
        const uint32_t pf[4] = {pack_f32(st[0][0], st[0][1]), pack_f32(st[0][2], st[0][3]),
                                pack_f32(st[1][0], st[1][1]), pack_f32(st[1][2], st[1][3])};
        const uint32_t dsf[4] = {pack_f32(dpt[0][0], dpt[0][1]), pack_f32(dpt[0][2], dpt[0][3]),
                                 pack_f32(dpt[1][0], dpt[1][1]), pack_f32(dpt[1][2], dpt[1][3])};
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t bdo[4], bq[4];
          load_b_cols<LD>(bdo, sdO, rc * 16, dt * 8, lane);
          load_b_cols<LD>(bq, sQ, rc * 16, dt * 8, lane);
          mma_16816(dv[dt], pf, bdo[0], bdo[1]);  // p^T do
          mma_16816(dv[dt + 1], pf, bdo[2], bdo[3]);
          mma_16816(dk[dt], dsf, bq[0], bq[1]);  // ds^T q
          mma_16816(dk[dt + 1], dsf, bq[2], bq[3]);
        }
      }
    }
  }

  __nv_bfloat16* gk = dkg + b * dks.batch + kvh * dks.head;
  __nv_bfloat16* gv = dvg + b * dvs.batch + kvh * dvs.head;
  const int ks_ = static_cast<int>(dks.row), vs_ = static_cast<int>(dvs.row);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (c0 < a.Skv) {
      *reinterpret_cast<uint32_t*>(gk + c0 * ks_ + col) =
          pack_f32(dk[dt][0] * a.scale, dk[dt][1] * a.scale);
      *reinterpret_cast<uint32_t*>(gv + c0 * vs_ + col) = pack_f32(dv[dt][0], dv[dt][1]);
    }
    if (c0 + 8 < a.Skv) {
      *reinterpret_cast<uint32_t*>(gk + (c0 + 8) * ks_ + col) =
          pack_f32(dk[dt][2] * a.scale, dk[dt][3] * a.scale);
      *reinterpret_cast<uint32_t*>(gv + (c0 + 8) * vs_ + col) = pack_f32(dv[dt][2], dv[dt][3]);
    }
  }
}

// --------------------------------------------------------------- launch ---

template <int D, bool CAUSAL, bool SHARED>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  const int smem = 2 * BK * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL, SHARED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.d.Sq + BQ - 1) / BQ, a.d.hq, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.dk,
                                           a.dv, a.d);
  return cudaGetLastError();
}

template <int D, bool CAUSAL, bool SHARED>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  // K, V, Q and dO tiles plus the q tile's lse and delta: 70 KB at D = 128,
  // above the 48 KB a block gets without opting in
  const int smem = (2 * BK + 2 * BQ) * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16)) +
                   2 * BQ * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dkv_kernel<D, CAUSAL, SHARED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.d.Skv + BK - 1) / BK, a.d.hkv, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.dk,
                                           a.dv, a.d);
  return cudaGetLastError();
}

template <int D, bool DKV, bool SHARED>
cudaError_t launch(const Args& a, int B, int causal, cudaStream_t st) {
  if (DKV)
    return causal ? launch_dkv<D, true, SHARED>(a, B, st)
                  : launch_dkv<D, false, SHARED>(a, B, st);
  return causal ? launch_dq<D, true, SHARED>(a, B, st) : launch_dq<D, false, SHARED>(a, B, st);
}

bool same(const Strides& x, const Strides& y) {
  return x.batch == y.batch && x.head == y.head && x.row == y.row;
}

// Checks what the kernels rely on and picks the instantiation. Where q, k
// and v share one set of strides (the fused array always; three views of one
// projection output), the kernels are built knowing it, and one address
// computation serves the Q, K and V tiles: at D = 128 the causal dq kernel
// then takes the time it took before it read three tensors (chip_smoke.py,
// K3a at the 2B decoder's shape), where separate strides cost it 1.4x.
template <bool DKV>
int dispatch(const Args& a, int B, int D, int causal, void* stream) {
  const Dims& d = a.d;
  const bool shared = same(d.qs, d.ks) && same(d.qs, d.vs);
  if (B <= 0 || d.Sq <= 0 || d.Skv <= 0 || d.hkv <= 0 || d.hq % d.hkv != 0 ||
      d.kv_valid <= 0 || d.kv_valid > d.Skv || (causal && d.Sq != d.Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 65535 || d.hq > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // row offsets within one (batch, head) slice are 32-bit in the kernels
  for (const long long row : {d.qs.row, d.os.row, d.dqs.row})
    if (row * d.Sq >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  for (const long long row : {d.ks.row, d.vs.row, d.dks.row, d.dvs.row})
    if (row * d.Skv >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = shared ? launch<64, DKV, true>(a, B, causal, st)
                 : launch<64, DKV, false>(a, B, causal, st);
  else if (D == 128)
    err = shared ? launch<128, DKV, true>(a, B, causal, st)
                 : launch<128, DKV, false>(a, B, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

using bf16p = const __nv_bfloat16*;

// The fused array: q, k, v and dq, dk, dv are head ranges of qkv and dqkv.
Args fused_args(const void* qkv, const void* dout, const void* lse, const void* delta,
                void* dqkv, int hq, int hkv, int S, int kv_valid, long long sb, long long sh,
                long long ss, long long db, long long dh, long long ds, long long gb,
                long long gh, long long gs, float scale) {
  const auto* q = static_cast<bf16p>(qkv);
  auto* g = static_cast<__nv_bfloat16*>(dqkv);
  const Strides in{sb, sh, ss}, grad{gb, gh, gs};
  return Args{q, q + hq * sh, q + (hq + hkv) * sh, static_cast<bf16p>(dout),
              static_cast<const float*>(lse), static_cast<const float*>(delta), g,
              g + hq * gh, g + (hq + hkv) * gh,
              Dims{hq, hkv, S, S, kv_valid, in, in, in, Strides{db, dh, ds}, grad, grad, grad,
                   scale}};
}

// Three tensors: strides[0..2] q's, [3..5] k's, [6..8] v's, [9..11] dout's,
// [12..14] dq's, [15..17] dk's, [18..20] dv's.
Args separate_args(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int hq,
                   int hkv, int Sq, int Skv, int kv_valid, const long long* s, float scale) {
  return Args{static_cast<bf16p>(q), static_cast<bf16p>(k), static_cast<bf16p>(v),
              static_cast<bf16p>(dout), static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
              static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
              Dims{hq, hkv, Sq, Skv, kv_valid, Strides{s[0], s[1], s[2]},
                   Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
                   Strides{s[9], s[10], s[11]}, Strides{s[12], s[13], s[14]},
                   Strides{s[15], s[16], s[17]}, Strides{s[18], s[19], s[20]}, scale}};
}

}  // namespace

extern "C" {

// All return 0 on success, else the cudaError_t of the failed launch.
// Shapes, dtypes, strides and alignment are checked by the Python wrappers.
// Strides are in elements, for (batch, head, row).

// The fused array: sb/sh/ss are qkv's strides, db/dh/ds dout's and gb/gh/gs
// dqkv's. The dq kernel writes heads [0, Hq) of dqkv, the dk/dv kernel heads
// [Hq, Hq + 2*Hkv).
int aigv_flash_attn_qkv_bwd_dq(const void* qkv, const void* dout, const void* lse,
                               const void* delta, void* dqkv, int B, int hq, int hkv, int S,
                               int D, int kv_valid, int causal, long long sb, long long sh,
                               long long ss, long long db, long long dh, long long ds,
                               long long gb, long long gh, long long gs, float scale,
                               void* stream) {
  return dispatch<false>(fused_args(qkv, dout, lse, delta, dqkv, hq, hkv, S, kv_valid, sb, sh,
                                    ss, db, dh, ds, gb, gh, gs, scale),
                         B, D, causal, stream);
}

int aigv_flash_attn_qkv_bwd_dkv(const void* qkv, const void* dout, const void* lse,
                                const void* delta, void* dqkv, int B, int hq, int hkv, int S,
                                int D, int kv_valid, int causal, long long sb, long long sh,
                                long long ss, long long db, long long dh, long long ds,
                                long long gb, long long gh, long long gs, float scale,
                                void* stream) {
  return dispatch<true>(fused_args(qkv, dout, lse, delta, dqkv, hq, hkv, S, kv_valid, sb, sh,
                                   ss, db, dh, ds, gb, gh, gs, scale),
                        B, D, causal, stream);
}

// Three tensors, with the 21 strides of separate_args. The dq entry writes dq
// and reads neither dk nor dv (they may be null); the dk/dv entry writes dk
// and dv and leaves dq alone.
int aigv_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, void* dk, void* dv,
                           int B, int hq, int hkv, int Sq, int Skv, int D, int kv_valid,
                           int causal, const long long* strides, float scale, void* stream) {
  return dispatch<false>(separate_args(q, k, v, dout, lse, delta, dq, dk, dv, hq, hkv, Sq, Skv,
                                       kv_valid, strides, scale),
                         B, D, causal, stream);
}

int aigv_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int hq, int hkv, int Sq, int Skv, int D, int kv_valid,
                            int causal, const long long* strides, float scale, void* stream) {
  return dispatch<true>(separate_args(q, k, v, dout, lse, delta, dq, dk, dv, hq, hkv, Sq, Skv,
                                      kv_valid, strides, scale),
                        B, D, causal, stream);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
