// Flash-attention forward for sm_90a (Hopper), with two entry points over one
// kernel.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (aigv_assessor_tpu/ops/pallas_attention.py:106) as both of its
// `pallas_call` sites reach it:
//
// - `aigv_flash_attn_qkv_fwd` (K1, the site at :835): off one fused
//   head-major qkv array (`flash_attention_qkv` -> `_fwd_qkv`), in the forms
//   the scoring and training paths run: bf16 output either head-major
//   [B, Hq, S, D] (`bhsd`) or as the dense rows [B, S, Hq*D] an
//   out-projection reads (`bsd`, the Pallas kernel's `dense_out`), and
//   optionally the per-row logsumexp that the backward kernels
//   (flash_attn_bwd.cu) read (`with_lse`).
// - `aigv_flash_attn_fwd` (K2, the site at :352): on three separate tensors
//   (`flash_attention` -> `_fwd`), q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D]
//   (`bshd`) or head-major (`bhsd`), which the weight-only decoder and the
//   QK-normalized ViT run, with the logsumexp when the call is
//   differentiated (`_flash_fwd` -> `_fwd(with_lse=True)`). Sq and Skv may
//   differ when not causal.
//
//   q, k, v  bf16, each read through its own strides (batch, head, row; D
//        contiguous, the other strides multiples of 16 bytes, a 16-byte
//        aligned base: what a TMA tensor map can describe), so slices and
//        permuted views of a projection output need no copy. The fused entry
//        passes three pointers into the one array, heads ordered [q | k | v].
//        q head h reads kv head h / G, G = Hq / Hkv.
//   out  bf16, written through its strides: [B, Hq, Sq, D] for `bhsd`,
//        [B, Sq, Hq*D] for `bsd` and `bshd`. The layouts differ only in the
//        output tensor map.
//   lse  fp32 [B, Hq, Sq] contiguous or null: log(sum_k exp(scale * q.k))
//        over the unmasked keys, natural-log units; -inf for a row with no
//        valid key (its output row is 0). Storing it changes nothing in `out`.
//   Keys at or beyond kv_valid (<= Skv) are masked (the ViT pads 1025 tokens
//   to 1032 and the tail rows hold evolved values, not zeros); `causal`
//   (Sq == Skv) masks keys after the query. Nothing is padded.
//
// Design (warp-specialised; one block per (q tile, q head, batch)):
// - Warpgroup 0 is the producer. It gives registers back (setmaxnreg 24) and
//   its first thread issues every load as a TMA box of [rows][64] bf16 in the
//   128-byte swizzle (one box per 64 columns of D): the block's Q tile once,
//   then K and V tiles into a ring of 2 stages, each completing on its own
//   mbarrier ("full") and refilled when every consumer warp has released it
//   ("empty"; K after its S product, V after its PV product). The tensor maps
//   are encoded on the host per call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so nothing links libcuda) and passed as
//   __grid_constant__ parameters. The row extent of the k and v maps is
//   kv_valid and that of q is Sq, so TMA zero-fills every row beyond them: a
//   non-finite garbage tail cannot reach the output through 0 * inf, and the
//   ragged edges need no code.
// - The other warpgroups are consumers of 64 q rows each: three at D = 64
//   (q tiles of 192 rows, setmaxnreg 160), two at D = 128 (128 rows, 240).
//   Both products run on the tensor cores as wgmma with fp32 accumulation:
//   S = Q K^T as m64nBNk16 with A = Q and B = K from shared memory (both
//   K-major), and O += P V as m64nDk16 with A = P from registers (the S
//   accumulator rounded to bf16 in place: two neighbouring 8-column blocks
//   of the accumulator are one k16 step's A fragment) and B = V from shared
//   memory through the MN-major descriptor, so V needs no transpose. Tile
//   t's S is issued before tile t-1's PV, and tile t's softmax runs while
//   that PV is in flight (FA3's intra-warpgroup overlap). The consumers take
//   turns at issuing their products (a ring of named barriers), so one
//   warpgroup's softmax runs under the others' products.
// - Keys per tile (BN): 128, or 176 at D = 128 where it pads kv_valid no
//   more than 128 does (kv_valid 1025: 6 tiles of 176 cover 1056 keys, 9 of
//   128 cover 1152).
// - The softmax is online, in base 2 (scale * log2(e) folded into one FMA
//   before ex2), with fp32 running max m and sum l per row, each row's
//   columns spread over 4 threads; P is rounded to bf16 before the PV
//   product, as the Pallas kernel does. Causal blocks stop at the diagonal
//   tile and run the q tiles in reverse, the longest first; only tiles that
//   cross the diagonal or kv_valid pay for the element mask. A consumer
//   warpgroup whose rows all lie at or beyond Sq idles.
// - The epilogue writes O in bf16 into the warpgroup's own Q rows in the
//   swizzled layout and stores it with one TMA box per 64 columns; rows at
//   or beyond Sq are clipped by the map.
//
// Budget (nvcc -Xptxas -v, CUDA 12.8): 168 registers a thread at launch for
// D = 128 (384 threads), 128 for D = 64 (512 threads), no spills; the
// consumers then run at 240 and 160. Shared memory: 88 KB at D = 64, 160 KB
// at D = 128 with 128-key tiles, 208 KB with 176-key tiles: one block per SM.
//
// What bounds it. Attention at the scoring shapes is compute-bound (the
// 2B ViT, B = 32, 16 heads, S = 1032, D = 64: ~520 FLOP per byte of qkv and
// output; the 2B LLM, causal, D = 128: ~700; the H100's balance is ~295),
// so the bound is the tensor-core rate. On an H100 80GB HBM3 at 700 W this
// kernel reached 37% of that bound at the 2B ViT's shape, 44% at the 2B
// LLM's and 50-54% at InternViT-6B's (chip_smoke.py, PERF.md). Removing the
// exponential gained 3.5% at D = 64 and removing the whole softmax about
// 25%, so what is left is mostly in the products' pipeline: at D = 64 each
// k16 step of the SS-form QK product reads Q and K from shared memory and
// every block re-reads all of its head's K and V from L2 (1 / BM bytes per
// FLOP). Open: TMA multicast of K / V across a cluster of q tiles, a
// persistent grid that overlaps one tile's epilogue with the next one's
// loads, the 8-row last q tile of S = 1032 (its block costs a full one),
// and a narrower S product for the diagonal tile's masked half.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int WG_ROWS = 64;           // q rows of one consumer warpgroup
constexpr int STAGES = 2;             // K/V ring depth
constexpr int BOX = 64;               // columns of one TMA box: one 128-byte swizzle row
constexpr int PRODUCER_REGS = 24;
constexpr uint32_t SCHED_BAR = 4;     // named barriers 4-6: the consumers' turns at the tensor cores

// Consumer warpgroups per block: three at D = 64 (160 registers each, S, O
// and P in 128 of them), two at D = 128 (240 each). With the producer's 24
// both fill the 65536 registers the launch allots: 128 * (24 + 3 * 160) =
// 128 * (24 + 2 * 240) = 64512.
__host__ __device__ constexpr int consumers(int D) { return D == 64 ? 3 : 2; }
__host__ __device__ constexpr int block_rows(int D) { return WG_ROWS * consumers(D); }
__host__ __device__ constexpr int block_threads(int D) { return 128 * (consumers(D) + 1); }
__host__ __device__ constexpr int consumer_regs(int D) { return D == 64 ? 160 : 240; }

// strides of one tensor in elements; D is contiguous
struct Strides {
  long long batch, head, row;
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: Q as
// D / 64 boxes of [block_rows rows][64], each K and V stage as D / 64 boxes
// of [BN rows][64], then the barriers.
template <int D, int BN>
struct Smem {
  static constexpr int BM = block_rows(D);
  static constexpr int Q = BM * D * 2;
  static constexpr int KV = BN * D * 2;  // one K or V tile
  static constexpr int K_OFF = Q;
  static constexpr int V_OFF = K_OFF + STAGES * KV;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
};

struct Barriers {
  uint64_t* q_full;
  uint64_t* k_full;   // [STAGES]
  uint64_t* v_full;   // [STAGES]
  uint64_t* k_empty;  // [STAGES]
  uint64_t* v_empty;  // [STAGES]
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int BN>
__device__ __forceinline__ void wgmma_s(float (&s)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 128)
    wgmma_ss_n128(s, a, b, scale_d);
  else
    wgmma_ss_n176(s, a, b, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_rs_n128_mn(o, p, b);
  else
    wgmma_rs_n64_mn(o, p, b);
}

// One consumer warpgroup: 64 q rows against every K/V tile of the block.
// Tile t's S = Q K^T is issued before tile t-1's O += P V, and tile t's
// softmax runs while that product is in flight. The `active` warpgroups
// issue their products in turn, warpgroup c after c - 1 (named barrier
// SCHED_BAR + c), so one warpgroup's softmax overlaps the others' products.
template <int D, int BN, bool CAUSAL>
__device__ __forceinline__ void consumer(const unsigned char* sQ, const unsigned char* sK,
                                         const unsigned char* sV, unsigned char* sO,
                                         Barriers bar, const CUtensorMap* to,
                                         float* __restrict__ lse, int c, int active, int q0,
                                         int h, int b, int hq, int Sq, int kv_valid,
                                         int n_tiles, float scale_log2) {
  constexpr int KV = Smem<D, BN>::KV;
  constexpr int BM = Smem<D, BN>::BM;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int tq = lane & 3;                    // thread within a row's group of 4
  const int qw0 = q0 + c * WG_ROWS;           // this warpgroup's first row
  const int r0 = qw0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const unsigned char* qa = sQ + c * WG_ROWS * 128;
  const bool turns = active > 1;
  const bool last_wg = c == active - 1;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[BN / 2];
  uint32_t p[BN / 16][4];
  float m[2] = {-INFINITY, -INFINITY};  // running max, base-2 units of the scaled scores
  float l[2] = {0.f, 0.f};              // partial row sums over this thread's columns
  float corr[2];

  auto my_turn = [&]() {
    if (turns) named_barrier_sync(SCHED_BAR + c, 256);
  };
  // the next warpgroup's turn; the last warpgroup gives the first its first
  // turn up front and its own last turn to nobody, so that every barrier
  // phase is completed exactly
  auto their_turn = [&](bool last) {
    if (turns && !(last_wg && last)) named_barrier_arrive(SCHED_BAR + (c + 1) % active, 256);
  };
  auto issue_s = [&](int st) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = make_desc_sw128(qa + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          make_desc_sw128(sK + st * KV + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024);
      wgmma_s<BN>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv<D>(o, p[kk], make_desc_sw128(sV + st * KV + kk * 16 * 128, BN * 128, 1024));
    wgmma_commit();
  };
  // the online softmax of tile t on s, in place: s becomes p in fp32, m and
  // l move on, corr is what O must be scaled by before this tile's product
  auto softmax = [&](int t) {
    const int k0 = t * BN;
    const bool need_mask = k0 + BN > kv_valid || (CAUSAL && k0 + BN - 1 > qw0);
    if (need_mask) {
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nb * 8 + tq * 2 + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          if (col >= kv_valid || (CAUSAL && col > row)) s[nb * 4 + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb * 4 + 0], s[nb * 4 + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb * 4 + 2], s[nb * 4 + 3]));
    }
    float mref[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four threads of a row group hold one row's columns; the scale
      // is positive, so the largest score scales to the largest scaled one
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      // a row with no valid key yet keeps m = -inf; exponentiate against 0
      mref[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = ex2(m[i] - mref[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[nb * 4 + e], scale_log2, -mref[e >> 1]));
        s[nb * 4 + e] = pe;
        l[e >> 1] += pe;
      }
    }
  };
  // P in bf16 as the A fragments of BN/16 steps of k16: the accumulator
  // layout of two neighbouring 8-key column blocks is one step's fragment
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto release = [&](uint64_t* empty) {
    if (lane == 0) mbar_arrive(empty);  // one arrival per warp
  };

  if (turns && last_wg) named_barrier_arrive(SCHED_BAR, 256);  // the first warpgroup goes first
  mbar_wait(bar.q_full, 0);
  mbar_wait(bar.k_full, 0);
  my_turn();
  issue_s(0);
  their_turn(false);
  wgmma_wait<0>();
  fence_regs(s);
  release(bar.k_empty);
  softmax(0);
  pack_p();

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % STAGES, pst = (t - 1) % STAGES;
    mbar_wait(bar.k_full + st, (t / STAGES) & 1);
    mbar_wait(bar.v_full + pst, ((t - 1) / STAGES) & 1);
    my_turn();
    issue_s(st);
    issue_pv(pst);
    their_turn(false);
    wgmma_wait<1>();  // S of tile t
    fence_regs(s);
    release(bar.k_empty + st);
    softmax(t);
    wgmma_wait<0>();  // P V of tile t - 1
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(p[kk]);
    release(bar.v_empty + pst);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[nb * 4 + 0] *= corr[0];
      o[nb * 4 + 1] *= corr[0];
      o[nb * 4 + 2] *= corr[1];
      o[nb * 4 + 3] *= corr[1];
    }
    pack_p();
  }
  const int lst = (n_tiles - 1) % STAGES;
  mbar_wait(bar.v_full + lst, ((n_tiles - 1) / STAGES) & 1);
  my_turn();
  issue_pv(lst);
  their_turn(true);
  wgmma_wait<0>();
  fence_regs(o);

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  // O in bf16 into this warpgroup's Q rows (read for the last time above),
  // in the swizzled layout of the output map's [64 rows][64] boxes, then one
  // TMA store per box; rows at or beyond Sq are not written
  unsigned char* so = sO + c * WG_ROWS * 128;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = nb * 8 + tq * 2;
    const int box = col / BOX, chunk = (col % BOX) / 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + lane / 4 + half * 8;
      unsigned char* dst =
          so + box * BM * 128 + row * 128 + ((chunk ^ (row & 7)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(o[nb * 4 + half * 2] * inv[half], o[nb * 4 + half * 2 + 1] * inv[half]);
    }
  }
  fence_proxy_async();
  named_barrier_sync(1 + c, 128);
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < D / BOX; ++j) tma_store_4d(to, so + j * BM * 128, j * BOX, qw0, h, b);
    tma_store_commit();
  }
  if (lse != nullptr && tq == 0) {
    // m is in base-2 units of the scaled scores; l = 0 and m = -inf give -inf
    float* lp = lse + (static_cast<long long>(b) * hq + h) * Sq;
    if (r0 < Sq) lp[r0] = (m[0] + log2f(l[0])) * 0.6931471805599453f;
    if (r0 + 8 < Sq) lp[r0 + 8] = (m[1] + log2f(l[1])) * 0.6931471805599453f;
  }
  if (tid == 0) tma_store_wait_read();
}

// One block per (q tile, q head, batch): a producer warpgroup whose first
// thread issues every TMA load, and consumers(D) warpgroups of 64 q rows.
template <int D, int BN, bool CAUSAL>
__global__ void __launch_bounds__(block_threads(D), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 float* __restrict__ lse, int Sq, int kv_valid, int hq, int group,
                 float scale_log2) {
  using S = Smem<D, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + S::K_OFF;
  unsigned char* sV = smem + S::V_OFF;
  Barriers bar;
  bar.q_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  bar.k_full = bar.q_full + 1;
  bar.v_full = bar.k_full + STAGES;
  bar.k_empty = bar.v_full + STAGES;
  bar.v_empty = bar.k_empty + STAGES;

  // causal q tiles in reverse, the longest first
  const int q_tile = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  constexpr int BM = S::BM;
  const int q0 = q_tile * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  // consumer warpgroups that hold rows
  const int active = min(consumers(D), (Sq - q0 + WG_ROWS - 1) / WG_ROWS);
  int n_tiles = (kv_valid + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (min(q0 + BM, Sq) - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar.k_full + s, 1);
      mbar_init(bar.v_full + s, 1);
      mbar_init(bar.k_empty + s, 4 * active);  // one arrival per consumer warp
      mbar_init(bar.v_empty + s, 4 * active);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      mbar_arrive_expect_tx(bar.q_full, S::Q);
      for (int j = 0; j < D / BOX; ++j)
        tma_load_4d(sQ + j * BM * 128, &tq, bar.q_full, j * BOX, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;
        mbar_wait(bar.k_empty + st, free_parity);
        mbar_arrive_expect_tx(bar.k_full + st, S::KV);
        for (int j = 0; j < D / BOX; ++j)
          tma_load_4d(sK + st * S::KV + j * BN * 128, &tk, bar.k_full + st, j * BOX, t * BN,
                      kvh, b);
        mbar_wait(bar.v_empty + st, free_parity);
        mbar_arrive_expect_tx(bar.v_full + st, S::KV);
        for (int j = 0; j < D / BOX; ++j)
          tma_load_4d(sV + st * S::KV + j * BN * 128, &tv, bar.v_full + st, j * BOX, t * BN,
                      kvh, b);
      }
    }
  } else {
    setmaxnreg_inc<consumer_regs(D)>();
    const int c = wg - 1;
    if (c < active)
      consumer<D, BN, CAUSAL>(sQ, sK, sV, smem, bar, &to, lse, c, active, q0, h, b, hq, Sq,
                              kv_valid, n_tiles, scale_log2);
  }
}

// ------------------------------------------------------------------- host --

// A [batch, heads, rows, D] bf16 view through its strides as a 4-d tensor map
// (D innermost), boxes of [box_rows][64] in the 128-byte swizzle. Rows at or
// beyond `rows` read as zeros and are not written.
bool make_map(CUtensorMap* map, const void* base, int D, long long rows, long long heads,
              long long batch, Strides st, int box_rows) {
  const PFN_cuTensorMapEncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long ext[3] = {rows, heads, batch};
  const long long el[3] = {st.row, st.head, st.batch};
  // a dimension of extent 1 is never stepped: give it the largest stride
  // of the others, so that its value (any multiple of 8) cannot matter
  long long widest = 2LL * D;
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1) widest = el[i] * 2 > widest ? el[i] * 2 : widest;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(ext[i] > 1 ? el[i] * 2 : widest);
  cuuint32_t box[4] = {BOX, static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v, out;
};

template <int D, int BN, bool CAUSAL>
cudaError_t launch(const Maps& maps, float* lse, int B, int hq, int hkv, int Sq, int kv_valid,
                   float scale_log2, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, BN, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D, BN>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + block_rows(D) - 1) / block_rows(D), hq, B);
  kernel<<<grid, block_threads(D), Smem<D, BN>::BYTES, stream>>>(maps.q, maps.k, maps.v, maps.out, lse,
                                                         Sq, kv_valid, hq, hq / hkv, scale_log2);
  return cudaGetLastError();
}

template <int D, int BN>
cudaError_t launch_bn(const Maps& maps, float* lse, int B, int hq, int hkv, int Sq, int kv_valid,
                      int causal, float scale_log2, cudaStream_t stream) {
  return causal ? launch<D, BN, true>(maps, lse, B, hq, hkv, Sq, kv_valid, scale_log2, stream)
                : launch<D, BN, false>(maps, lse, B, hq, hkv, Sq, kv_valid, scale_log2, stream);
}

// Checks what the kernel relies on, encodes the four tensor maps and picks
// the instantiation.
int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
             __nv_bfloat16* out, float* lse, int B, int hq, int hkv, int Sq, int Skv, int D,
             int kv_valid, int causal, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || hkv <= 0 || hq % hkv != 0 || kv_valid <= 0 ||
      kv_valid > Skv || (causal && Sq != Skv) || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 65535 || hq > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // keys per tile: at D = 128, 176 where it pads kv_valid no more than 128
  // does (1025 keys: 6 tiles of 176 cover 1056, 9 of 128 cover 1152), else
  // 128; at D = 64 always 128 (176 would not fit three warpgroups' registers)
  const auto padded = [kv_valid](int bn) { return (kv_valid + bn - 1) / bn * bn; };
  const int bn = D == 128 && padded(176) <= padded(128) ? 176 : 128;
  Maps maps;
  // a view TMA cannot describe (strides off 16 bytes, a base off 16 bytes)
  if (!make_map(&maps.q, q, D, Sq, hq, B, qs, block_rows(D)) ||
      !make_map(&maps.k, k, D, kv_valid, hkv, B, ks, bn) ||
      !make_map(&maps.v, v, D, kv_valid, hkv, B, vs, bn) ||
      !make_map(&maps.out, out, D, Sq, hq, B, os, WG_ROWS))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  cudaError_t err;
  if (D == 64)
    err = launch_bn<64, 128>(maps, lse, B, hq, hkv, Sq, kv_valid, causal, scale_log2, st);
  else
    err = bn == 176 ? launch_bn<128, 176>(maps, lse, B, hq, hkv, Sq, kv_valid, causal, scale_log2, st)
                    : launch_bn<128, 128>(maps, lse, B, hq, hkv, Sq, kv_valid, causal, scale_log2, st);
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
