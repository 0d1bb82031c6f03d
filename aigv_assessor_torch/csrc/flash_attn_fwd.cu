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
// Design (warp-specialised; not causal, one block per (q tile, q head,
// batch); causal, one persistent block an SM, below):
// - Warpgroup 0 is the producer. It gives registers back (setmaxnreg 24) and
//   its first thread issues every load as a TMA box of `Layout<D>`
//   (hopper.cuh, the backward's too): [rows][64] bf16 in the 128-byte swizzle
//   at D = 64 and 128, [rows][32] in the 64-byte swizzle at D = 96, one box
//   per 64 or 32 columns of D. It loads a q tile's Q once,
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
//   and 96 (q tiles of 192 rows, setmaxnreg 160), two at D = 128 (128 rows,
//   240).
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
// - Keys per tile (BN): 128 at D = 64; 96 at D = 96; at D = 128 176 where
//   it pads kv_valid no more than 128 does (kv_valid 1025: 6 tiles of 176
//   cover 1056 keys, 9 of 128 cover 1152), else 128.
// - The softmax is online, in base 2 (scale * log2(e) folded into one FMA
//   before ex2), with fp32 running max m and sum l per row, each row's
//   columns spread over 4 threads; P is rounded to bf16 before the PV
//   product, as the Pallas kernel does. A causal q tile stops at its
//   diagonal tile; only tiles that cross the diagonal or kv_valid pay for
//   the element mask. A consumer warpgroup whose rows all lie at or beyond
//   Sq idles.
// - The epilogue writes O in bf16 into the warpgroup's own Q rows in the
//   swizzled layout and stores it with one TMA box per 64 columns; rows at
//   or beyond Sq are clipped by the map.
//
// The causal schedule (`flash_fwd_causal_kernel`). A causal q tile's work is
// its count of key tiles, from 1 to the whole sequence's, so the order of
// the tiles decides how the launch ends. Three things:
// - One order for the whole launch, longest first: the items (q tile, q
//   head, sample) run in groups of m q tiles, every group's tiles longer
//   than the next group's, so the launch ends on its shortest items. m = 1
//   while the K and V of the whole batch fit in 32 MiB of L2 (InternVL2-1B at
//   B = 4: 4.1 MiB), one more for every 32 MiB past that (the 2B and 26B
//   decoders at B = 4: 33 MiB, m = 2; Phi-3-mini at B = 4: 99 MiB, m = 4):
//   each (q head, sample)'s m tiles of a group run back to back and share
//   their K and V from L2 (Phi-3-mini at m = 1: 7-8% slower than the
//   parent's order).
// - q tiles aligned to the end of the sequence: the ragged one (S mod BM
//   rows; one row at S = 2113, BM = 192) is the first, reads one key tile
//   and ends the order, where the parent's last tile of one row read all
//   17. TMA takes no box at a negative row, so it loads from row 0 and its
//   rows past the ragged end are computed and dropped (`causal_item`).
// - One block an SM (the SM count read once per device), dealt the items
//   snake-wise in rounds of the grid, with no counter. The K/V ring and the
//   consumers' turns run on from one item into the next, so the next item's
//   first product follows this one's last, and the producer loads the next
//   item's Q into a second Q buffer while this item's output is stored from
//   the first. Not at D = 128 over 176-key tiles (2 x 32 KB of Q and 176 KB
//   of ring do not fit in 227 KB): there one Q buffer, whose next Q waits
//   for the store; this keeps every causal launch on the tile width the
//   parent chose, so out and lse stay bit-equal to the parent's.
// Each row still meets its key tiles from key 0 in steps of BN; a tile
// past its diagonal adds exact zeros (corr = ex2(0) = 1), so where a row's
// tile now holds more key tiles than before, its out and lse are the same
// bits.
//
// Head dims: 64, 96 (Phi-3-mini's 3072 / 32, InternVL2-4B's decoder) and
// 128, each its own instantiation. At D = 96 a tile row is three boxes of 32
// columns in the 64-byte swizzle, 192 bytes, so nothing is padded: S = Q K^T
// runs D / 16 = 6 k16 steps and O += P V runs at N = 96 (m64n96k16, V
// MN-major over three 32-wide column blocks), so O is 48 registers a thread.
// What that frees went to a third consumer warpgroup: S, O and P of 96-key
// tiles take 120 of the 128 registers a thread of a 512-thread block can
// have (128-key tiles would take 144: ptxas spilled 144 bytes). The softmax
// scale comes from the caller (96^-0.5), never from the template's D.
//
// Budget (nvcc -Xptxas -v, CUDA 12.8): 168 registers a thread at launch for
// D = 128 (384 threads), 128 for D = 64 and 96 (512 threads), no spills but
// the causal D = 128 176-key body's 4-byte one; the consumers then run at
// 240 and 160. Shared memory, not causal / causal: 88 / 112 KB at D = 64,
// 108 / 144 KB at D = 96, 160 / 192 KB at D = 128 with 128-key tiles, 208 /
// 208 KB with 176-key tiles: one block per SM.
//
// What bounds it. Attention at the scoring shapes is compute-bound (the
// 2B ViT, B = 32, 16 heads, S = 1032, D = 64: ~520 FLOP per byte of qkv and
// output; the 2B LLM, causal, D = 128: ~700; the H100's balance is ~295),
// so the bound is the tensor-core rate. On an H100 80GB HBM3 at 700 W this
// kernel reached 37% of that bound at the 2B ViT's shape, 44% at the 2B
// LLM's, 50-54% at InternViT-6B's and 41% at Phi-3-mini's [4, 32 / 32,
// 2113, 96] causal (0.96x SDPA's forward; chip_smoke.py,
// tools/attention_ab.py, PERF.md); the causal schedule took Qwen2's [4, 14 /
// 2, 2113, 64] from 0.110 to 0.093 ms (SDPA 0.100) and the 2B LLM's from
// 0.171 to 0.149 (SDPA 0.155). At D = 96 the softmax's work per key is
// that of D = 128 over three quarters of the products: a K/V ring of 3 or 4
// stages, 112-key tiles, and two consumers over 128-key tiles ran within 3%
// of this body; two over 176- or 192-key tiles 3-9% slower, 80-key tiles 8%.
// Removing the exponential gained 3.5% at D = 64 and removing the whole
// softmax about 25%, so what is left is mostly in the products' pipeline: at
// D = 64 each k16 step of the SS-form QK product reads Q and K from shared
// memory and every block re-reads all of its head's K and V from L2 (1 / BM
// bytes per FLOP). Open: TMA multicast of K / V across a cluster of q tiles
// (or of the q heads of one kv head), the non-causal launches' persistent
// grid and their 8-row last q tile of S = 1032 (its block costs a full one),
// and a narrower S product for the diagonal tile's masked half.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int WG_ROWS = 64;           // q rows of one consumer warpgroup
constexpr int STAGES = 2;             // K/V ring depth
constexpr int PRODUCER_REGS = 24;
constexpr uint32_t SCHED_BAR = 4;     // named barriers 4-6: the consumers' turns at the tensor cores

// Consumer warpgroups per block: three at D = 64 and 96 (160 registers each;
// S, O and P take 128 of them at D = 64 with 128-key tiles and 120 at D = 96
// with 96-key tiles), two at D = 128 (240 each). With the producer's 24 both
// fill the 65536 registers the launch allots: 128 * (24 + 3 * 160) =
// 128 * (24 + 2 * 240) = 64512.
__host__ __device__ constexpr int consumers(int D) { return D == 128 ? 2 : 3; }
__host__ __device__ constexpr int block_rows(int D) { return WG_ROWS * consumers(D); }
__host__ __device__ constexpr int block_threads(int D) { return 128 * (consumers(D) + 1); }
__host__ __device__ constexpr int consumer_regs(int D) { return D == 128 ? 240 : 160; }

// strides of one tensor in elements; D is contiguous
struct Strides {
  long long batch, head, row;
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: QBUF
// Q tiles as Layout<D>'s boxes of [block_rows rows][COLS], each K and V stage
// as boxes of [BN rows][COLS], then the barriers.
template <int D, int BN, int QBUF = 1>
struct Smem {
  static constexpr int BM = block_rows(D);
  static constexpr int Q = BM * D * 2;   // one Q tile
  static constexpr int KV = BN * D * 2;  // one K or V tile
  static constexpr int K_OFF = QBUF * Q;
  static constexpr int V_OFF = K_OFF + STAGES * KV;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * QBUF + 4 * STAGES) + 1024;  // + alignment slack
  static constexpr bool FITS = BYTES <= 227 * 1024;
};

// Q tiles of the causal kernel: two (the next item's Q loads while this
// one's output is stored from the other) where they fit; not at D = 128 over
// 176-key tiles (2 x 32 KB of Q + 176 KB of ring), whose next Q waits for the
// store
template <int D, int BN>
__host__ __device__ constexpr int causal_qbuf() {
  return Smem<D, BN, 2>::FITS ? 2 : 1;
}

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
  if constexpr (BN == 96)
    wgmma_ss_n96(s, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_ss_n128(s, a, b, scale_d);
  else
    wgmma_ss_n176(s, a, b, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_rs_n128_mn(o, p, b);
  else if constexpr (D == 96)
    wgmma_rs_n96_mn(o, p, b);
  else
    wgmma_rs_n64_mn(o, p, b);
}

// Byte offset of k16 step kk's 16 columns in a [rows][D] tile of Layout<D>'s
// boxes: box 16 kk / COLS, 32 bytes into its rows per step within it
template <int D>
__host__ __device__ constexpr int k_offset(int rows, int kk) {
  using L = Layout<D>;
  return (kk * 16 / L::COLS) * rows * L::ROW + (kk * 16 % L::COLS) * 2;
}

// One consumer warpgroup: 64 q rows against every K/V tile of the block.
// Tile t's S = Q K^T is issued before tile t-1's O += P V, and tile t's
// softmax runs while that product is in flight. The `active` warpgroups
// issue their products in turn, warpgroup c after c - 1 (named barrier
// SCHED_BAR + c), so one warpgroup's softmax overlaps the others' products.
// In the causal kernel the K/V ring and the turns run on across a block's
// items: `ring` is the count of tiles before this item's first, `end` is one
// past the item's last row (rows from end on belong to the next item and are
// not stored), `q_empty` is released once the output's store has read this
// item's Q buffer, and every consumer warpgroup takes part in the turns of
// every item (`active` is consumers(D)); the last warpgroup gives the first
// its first turn only in the block's `first` item, and gives its own last
// turn to nobody only in its `last`, so that the next item's first product
// follows this one's last without waiting for its epilogue.
template <int D, int BN, bool CAUSAL>
__device__ __forceinline__ void consumer(const unsigned char* sQ, const unsigned char* sK,
                                         const unsigned char* sV, unsigned char* sO,
                                         Barriers bar, const CUtensorMap* to,
                                         float* __restrict__ lse, int c, int active, int q0,
                                         int h, int b, int hq, int Sq, int kv_valid,
                                         int n_tiles, float scale_log2, int ring, int end,
                                         uint64_t* q_empty, bool first, bool last) {
  using L = Layout<D>;
  constexpr int KV = Smem<D, BN>::KV;
  constexpr int BM = Smem<D, BN>::BM;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int tq = lane & 3;                    // thread within a row's group of 4
  const int qw0 = q0 + c * WG_ROWS;           // this warpgroup's first row
  const int r0 = qw0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const unsigned char* qa = sQ + c * WG_ROWS * L::ROW;
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
      const uint64_t da = L::desc(qa + k_offset<D>(BM, kk), 16);
      const uint64_t db = L::desc(sK + st * KV + k_offset<D>(BN, kk), 16);
      wgmma_s<BN>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv<D>(o, p[kk], L::desc(sV + st * KV + kk * 16 * L::ROW, BN * L::ROW));
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

  // the first warpgroup goes first
  if (turns && last_wg && (!CAUSAL || first)) named_barrier_arrive(SCHED_BAR, 256);
  if constexpr (!CAUSAL) mbar_wait(bar.q_full, 0);  // the causal kernel waits before the call
  const int st0 = ring % STAGES;
  mbar_wait(bar.k_full + st0, (ring / STAGES) & 1);
  my_turn();
  issue_s(st0);
  their_turn(false);
  wgmma_wait<0>();
  fence_regs(s);
  release(bar.k_empty + st0);
  softmax(0);
  pack_p();

  for (int t = 1; t < n_tiles; ++t) {
    const int g = ring + t;
    const int st = g % STAGES, pst = (g - 1) % STAGES;
    mbar_wait(bar.k_full + st, (g / STAGES) & 1);
    mbar_wait(bar.v_full + pst, ((g - 1) / STAGES) & 1);
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
  const int lst = (ring + n_tiles - 1) % STAGES;
  mbar_wait(bar.v_full + lst, ((ring + n_tiles - 1) / STAGES) & 1);
  my_turn();
  issue_pv(lst);
  their_turn(!CAUSAL || last);
  wgmma_wait<0>();
  fence_regs(o);
  if constexpr (CAUSAL) release(bar.v_empty + lst);  // the ring runs on into the next item

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffff, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  // O in bf16 into this warpgroup's Q rows (read for the last time above),
  // in the swizzled layout of the output map's [64 rows][COLS] boxes, then
  // one TMA store per box; rows at or beyond Sq are not written
  unsigned char* so = sO + c * WG_ROWS * L::ROW;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = nb * 8 + tq * 2;
    const int box = col / L::COLS, chunk = (col % L::COLS) / 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + lane / 4 + half * 8;
      unsigned char* dst = so + box * BM * L::ROW + L::at(row, chunk) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(o[nb * 4 + half * 2] * inv[half], o[nb * 4 + half * 2 + 1] * inv[half]);
    }
  }
  fence_proxy_async();
  named_barrier_sync(1 + c, 128);
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < L::BOXES; ++j)
      tma_store_4d(to, so + j * BM * L::ROW, j * L::COLS, qw0, h, b);
    tma_store_commit();
  }
  if (lse != nullptr && tq == 0) {
    // m is in base-2 units of the scaled scores; l = 0 and m = -inf give -inf
    float* lp = lse + (static_cast<long long>(b) * hq + h) * Sq;
    const int row_end = CAUSAL ? end : Sq;
    if (r0 < row_end) lp[r0] = (m[0] + log2f(l[0])) * 0.6931471805599453f;
    if (r0 + 8 < row_end) lp[r0 + 8] = (m[1] + log2f(l[1])) * 0.6931471805599453f;
  }
  if (tid == 0) {
    tma_store_wait_read();
    if constexpr (CAUSAL) mbar_arrive(q_empty);
  }
}

// A consumer warpgroup with no row in a causal item (the ragged first tile's
// last warpgroups) still takes part in it as `consumer` does, without the
// products: each warp releases every K/V tile once it has arrived, so that
// the empty barriers count every consumer warp in every item, it takes its
// n_tiles + 1 turns, and it releases its Q buffer.
template <int D>
__device__ __forceinline__ void pass_item(Barriers bar, int c, int ring, int n_tiles,
                                          uint64_t* q_empty, bool first, bool last) {
  const bool lane0 = threadIdx.x % 32 == 0, last_wg = c == consumers(D) - 1;
  const uint32_t mine = SCHED_BAR + c, next = SCHED_BAR + (c + 1) % consumers(D);
  if (last_wg && first) named_barrier_arrive(SCHED_BAR, 256);
  for (int t = 0; t <= n_tiles; ++t) {
    const int g = ring + t;
    if (t < n_tiles) mbar_wait(bar.k_full + g % STAGES, (g / STAGES) & 1);
    if (t > 0) mbar_wait(bar.v_full + (g - 1) % STAGES, ((g - 1) / STAGES) & 1);
    named_barrier_sync(mine, 256);
    if (!(last_wg && last && t == n_tiles)) named_barrier_arrive(next, 256);
    if (lane0 && t < n_tiles) mbar_arrive(bar.k_empty + g % STAGES);
    if (lane0 && t > 0) mbar_arrive(bar.v_empty + (g - 1) % STAGES);
  }
  if (threadIdx.x % 128 == 0) mbar_arrive(q_empty);
}

// Not causal: one block per (q tile, q head, batch), a producer warpgroup
// whose first thread issues every TMA load, and consumers(D) warpgroups of
// 64 q rows.
template <int D, int BN>
__global__ void __launch_bounds__(block_threads(D), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 float* __restrict__ lse, int Sq, int kv_valid, int hq, int group,
                 float scale_log2) {
  using S = Smem<D, BN>;
  static_assert(S::FITS, "more shared memory than a block may have");
  using L = Layout<D>;
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

  constexpr int BM = S::BM;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  // consumer warpgroups that hold rows
  const int active = min(consumers(D), (Sq - q0 + WG_ROWS - 1) / WG_ROWS);
  const int n_tiles = (kv_valid + BN - 1) / BN;

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
      for (int j = 0; j < L::BOXES; ++j)
        tma_load_4d(sQ + j * BM * L::ROW, &tq, bar.q_full, j * L::COLS, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;
        mbar_wait(bar.k_empty + st, free_parity);
        mbar_arrive_expect_tx(bar.k_full + st, S::KV);
        for (int j = 0; j < L::BOXES; ++j)
          tma_load_4d(sK + st * S::KV + j * BN * L::ROW, &tk, bar.k_full + st, j * L::COLS,
                      t * BN, kvh, b);
        mbar_wait(bar.v_empty + st, free_parity);
        mbar_arrive_expect_tx(bar.v_full + st, S::KV);
        for (int j = 0; j < L::BOXES; ++j)
          tma_load_4d(sV + st * S::KV + j * BN * L::ROW, &tv, bar.v_full + st, j * L::COLS,
                      t * BN, kvh, b);
      }
    }
  } else {
    setmaxnreg_inc<consumer_regs(D)>();
    const int c = wg - 1;
    if (c < active)
      consumer<D, BN, false>(sQ, sK, sV, smem, bar, &to, lse, c, active, q0, h, b, hq, Sq,
                             kv_valid, n_tiles, scale_log2, 0, Sq, nullptr, true, true);
  }
}

// One causal work item: rows [q0, end) of q head h of sample b (pair p = b
// * hq + h), q tile `band` counted from the end of the sequence (band 0 holds
// its last BM rows). Item i lies in the group of m bands starting at band
// g0 = i / (m * pairs) * m, whose items run pair by pair, each pair's bands
// in turn, so that every item of a group is longer than every item of the
// next and a pair's m items run at about the same time, reading the same K
// and V from L2. Tiles are aligned to the end, so the ragged one (Sq mod BM
// rows) is the first of the sequence and reads the fewest key tiles, not the
// most. It is loaded from row 0 as a whole tile (a TMA box at a negative row
// faults): its rows from `end` on are the next tile's, computed over too few
// keys and never stored (the head map's rows end there).
struct Item {
  int q0, end, h, b, n_tiles;
};

template <int BM, int BN>
__device__ __forceinline__ Item causal_item(int i, int pairs, int m, int nq, int hq, int Sq,
                                            int kv_tiles) {
  const int g0 = i / (m * pairs) * m;  // the group's first band
  const int mg = min(m, nq - g0);      // its bands
  const int local = i - g0 * pairs;
  const int p = local / mg;
  const int band = g0 + (local - p * mg);
  Item w;
  w.end = Sq - band * BM;
  w.q0 = max(w.end - BM, 0);
  w.h = p % hq;
  w.b = p / hq;
  w.n_tiles = min(kv_tiles, (w.end - 1) / BN + 1);
  return w;
}

// Causal: one persistent block an SM over the items of `causal_item`, longest
// group first over the whole launch, dealt in rounds of gridDim.x,
// snake-wise: block s takes item s of the even rounds and item gridDim.x - 1
// - s of the odd ones (no counter: a CUDA graph replays the launch as it
// is). The K/V ring and the consumers' turns run on across a block's items,
// and the producer loads the next item's Q into the other Q buffer while the
// consumers finish this one and store its output.
template <int D, int BN>
__global__ void __launch_bounds__(block_threads(D), 1)
flash_fwd_causal_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to,
                        const __grid_constant__ CUtensorMap to_head, float* __restrict__ lse, int Sq,
                        int kv_valid, int hq, int group, int pairs, int m, int n_items,
                        float scale_log2) {
  constexpr int QBUF = causal_qbuf<D, BN>();
  using S = Smem<D, BN, QBUF>;
  static_assert(S::FITS, "more shared memory than a block may have");
  using L = Layout<D>;
  constexpr int BM = S::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem + S::K_OFF;
  unsigned char* sV = smem + S::V_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);  // [QBUF]
  uint64_t* q_empty = q_full + QBUF;                                   // [QBUF]
  Barriers bar;
  bar.q_full = q_full;
  bar.k_full = q_empty + QBUF;
  bar.v_full = bar.k_full + STAGES;
  bar.k_empty = bar.v_full + STAGES;
  bar.v_empty = bar.k_empty + STAGES;
  const int kv_tiles = (kv_valid + BN - 1) / BN;
  const int nq = (Sq + BM - 1) / BM;
  // the k-th item of this block
  const auto item = [&](int k) {
    return k * static_cast<int>(gridDim.x) +
           ((k & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : static_cast<int>(blockIdx.x));
  };

  if (threadIdx.x == 0) {
    for (int q = 0; q < QBUF; ++q) {
      mbar_init(q_full + q, 1);
      mbar_init(q_empty + q, consumers(D));  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar.k_full + s, 1);
      mbar_init(bar.v_full + s, 1);
      mbar_init(bar.k_empty + s, 4 * consumers(D));  // every consumer warp, in every item
      mbar_init(bar.v_empty + s, 4 * consumers(D));
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      int ring = 0;
      for (int k = 0, i = item(0); i < n_items; i = item(++k)) {
        const Item w = causal_item<BM, BN>(i, pairs, m, nq, hq, Sq, kv_tiles);
        const int qb = k % QBUF, kvh = w.h / group;
        unsigned char* sQ = smem + qb * S::Q;
        mbar_wait(q_empty + qb, ((k / QBUF) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full + qb, S::Q);
        for (int j = 0; j < L::BOXES; ++j)
          tma_load_4d(sQ + j * BM * L::ROW, &tq, q_full + qb, j * L::COLS, w.q0, w.h, w.b);
        for (int t = 0; t < w.n_tiles; ++t) {
          const int g = ring + t, st = g % STAGES;
          const uint32_t free_parity = ((g / STAGES) & 1) ^ 1;
          mbar_wait(bar.k_empty + st, free_parity);
          mbar_arrive_expect_tx(bar.k_full + st, S::KV);
          for (int j = 0; j < L::BOXES; ++j)
            tma_load_4d(sK + st * S::KV + j * BN * L::ROW, &tk, bar.k_full + st, j * L::COLS,
                        t * BN, kvh, w.b);
          mbar_wait(bar.v_empty + st, free_parity);
          mbar_arrive_expect_tx(bar.v_full + st, S::KV);
          for (int j = 0; j < L::BOXES; ++j)
            tma_load_4d(sV + st * S::KV + j * BN * L::ROW, &tv, bar.v_full + st, j * L::COLS,
                        t * BN, kvh, w.b);
        }
        ring += w.n_tiles;
      }
    }
  } else {
    setmaxnreg_inc<consumer_regs(D)>();
    const int c = wg - 1;
    int ring = 0;
    for (int k = 0, i = item(0); i < n_items; i = item(++k)) {
      const Item w = causal_item<BM, BN>(i, pairs, m, nq, hq, Sq, kv_tiles);
      const int qb = k % QBUF;
      unsigned char* sQ = smem + qb * S::Q;
      // every consumer waits for the item's Q, so that no release of this
      // buffer can count towards the phase of its previous item
      mbar_wait(q_full + qb, (k / QBUF) & 1);
      const bool last = item(k + 1) >= n_items;
      const CUtensorMap* out = w.q0 == 0 ? &to_head : &to;
      if (w.q0 + c * WG_ROWS < w.end)  // the warpgroup holds rows of the item
        consumer<D, BN, true>(sQ, sK, sV, sQ, bar, out, lse, c, consumers(D), w.q0, w.h, w.b,
                              hq, Sq, kv_valid, w.n_tiles, scale_log2, ring, w.end, q_empty + qb,
                              k == 0, last);
      else
        pass_item<D>(bar, c, ring, w.n_tiles, q_empty + qb, k == 0, last);
      ring += w.n_tiles;
    }
  }
}

// ------------------------------------------------------------------- host --

// A [batch, heads, rows, D] bf16 view through its strides as a 4-d tensor map
// (D innermost), boxes of [box_rows][COLS] in Layout<D>'s swizzle. Rows at or
// beyond `rows` read as zeros and are not written.
template <int D>
bool make_map(CUtensorMap* map, const void* base, long long rows, long long heads,
              long long batch, Strides st, int box_rows) {
  using L = Layout<D>;
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
  cuuint32_t box[4] = {L::COLS, static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                L::SW64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out_head: the output's first rows, as many as the causal kernel's first q
// tile holds (Sq - (q tiles - 1) * block_rows(D))
struct Maps {
  CUtensorMap q, k, v, out, out_head;
};

// the SM count of the current device, read once per device; 0 on an error
int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0 &&
      cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return cache[dev];
}

template <int D, int BN>
cudaError_t launch_bn(const Maps& maps, float* lse, int B, int hq, int hkv, int Sq, int kv_valid,
                      int causal, float scale_log2, cudaStream_t stream) {
  if (causal) {
    auto kernel = flash_fwd_causal_kernel<D, BN>;
    constexpr int bytes = Smem<D, BN, causal_qbuf<D, BN>()>::BYTES;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    const int pairs = hq * B;
    const int nq = (Sq + block_rows(D) - 1) / block_rows(D);
    const int n_items = nq * pairs;
    // bands a group: one while the batch's K and V (kv_valid rows of hkv
    // heads) fit in 32 MiB of L2, and one more for every 32 MiB past that
    const long long kv_bytes = 4LL * kv_valid * D * hkv * B;
    const long long groups = (kv_bytes + (32LL << 20) - 1) >> 25;
    const int m = static_cast<int>(groups < nq ? groups : nq);
    kernel<<<min(n_items, sms), block_threads(D), bytes, stream>>>(
        maps.q, maps.k, maps.v, maps.out, maps.out_head, lse, Sq, kv_valid, hq, hq / hkv, pairs,
        m, n_items, scale_log2);
    return cudaGetLastError();
  }
  auto kernel = flash_fwd_kernel<D, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D, BN>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + block_rows(D) - 1) / block_rows(D), hq, B);
  kernel<<<grid, block_threads(D), Smem<D, BN>::BYTES, stream>>>(maps.q, maps.k, maps.v, maps.out, lse,
                                                         Sq, kv_valid, hq, hq / hkv, scale_log2);
  return cudaGetLastError();
}

// Encodes the four tensor maps and launches the head dim's instantiation.
// Keys per tile: at D = 128, 176 where it pads kv_valid no more than 128 does
// (1025 keys: 6 tiles of 176 cover 1056, 9 of 128 cover 1152), else 128; at
// D = 64 always 128 and at D = 96 always 96 (three warpgroups' registers hold
// neither 176 nor, at D = 96, 128).
template <int D>
cudaError_t launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     __nv_bfloat16* out, float* lse, int B, int hq, int hkv, int Sq,
                     int kv_valid, int causal, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale_log2, cudaStream_t st) {
  constexpr int NARROW = D == 96 ? 96 : 128;
  const auto padded = [kv_valid](int bn) { return (kv_valid + bn - 1) / bn * bn; };
  const bool wide = D == 128 && padded(176) <= padded(128);
  const int bn = wide ? 176 : NARROW;
  Maps maps;
  // a view TMA cannot describe (strides off 16 bytes, a base off 16 bytes)
  const int head_rows = Sq - (Sq - 1) / block_rows(D) * block_rows(D);
  if (!make_map<D>(&maps.q, q, Sq, hq, B, qs, block_rows(D)) ||
      !make_map<D>(&maps.k, k, kv_valid, hkv, B, ks, bn) ||
      !make_map<D>(&maps.v, v, kv_valid, hkv, B, vs, bn) ||
      !make_map<D>(&maps.out, out, Sq, hq, B, os, WG_ROWS) ||
      (causal && !make_map<D>(&maps.out_head, out, head_rows, hq, B, os, WG_ROWS)))
    return cudaErrorInvalidPitchValue;
  if constexpr (D == 128) {
    if (wide) return launch_bn<D, 176>(maps, lse, B, hq, hkv, Sq, kv_valid, causal, scale_log2, st);
  }
  return launch_bn<D, NARROW>(maps, lse, B, hq, hkv, Sq, kv_valid, causal, scale_log2, st);
}

// Checks what the kernel relies on and picks the head dim's instantiation.
int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
             __nv_bfloat16* out, float* lse, int B, int hq, int hkv, int Sq, int Skv, int D,
             int kv_valid, int causal, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || hkv <= 0 || hq % hkv != 0 || kv_valid <= 0 ||
      kv_valid > Skv || (causal && Sq != Skv) || (D != 64 && D != 96 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  // the grid's y and z; the causal launch's items, numbered in an int
  if (B > 65535 || hq > 65535 || (Sq + 127LL) / 128 * hq * B > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto run = [&](auto d) {
    return launch_d<decltype(d)::value>(q, k, v, out, lse, B, hq, hkv, Sq, kv_valid, causal, qs,
                                        ks, vs, os, scale_log2, st);
  };
  const cudaError_t err = D == 64   ? run(std::integral_constant<int, 64>())
                          : D == 96 ? run(std::integral_constant<int, 96>())
                                    : run(std::integral_constant<int, 128>());
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
