// Flash-attention backward for sm_90a (Hopper), over separate q, k, v tensors,
// with two pairs of entry points over one pair of kernels.
//
// Replaces the two Pallas TPU kernels of `_bwd` in
// aigv_assessor_tpu/ops/pallas_attention.py:
//   `_bwd_dq_kernel`   -> flash_bwd_dq_kernel   (delta and dq)
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
//   q     [B, Hq, Sq, D] bf16 (or any layout): each of q, k, v, out, dout, dq,
//         dk and dv is read or written through its own (batch, head, row)
//         strides, D contiguous, the other strides multiples of 16 bytes and
//         a 16-byte aligned base (what a TMA tensor map can describe), so
//         slices and permuted views of a projection output need no copy. The
//         fused entries pass pointers into one array, heads ordered
//         [q | k | v]. q head h reads kv head h / G, G = Hq / Hkv.
//   k, v  [B, Hkv, Skv, D] bf16.
//   out, dout [B, Hq, Sq, D] bf16: the forward's output and its gradient.
//   lse   [B, Hq, Sq] fp32 contiguous, the forward's logsumexp in natural-log
//         units; -inf marks a row with no valid key, whose p is 0 here.
//   delta [B, Hq, Sq] fp32 contiguous, rowsum(dout * out) summed in fp32:
//         written by the dq kernel, read by the dk/dv kernel, which the
//         caller launches after it on the same stream.
//   dq    [B, Hq, Sq, D] bf16, written by the dq kernel, every row below Sq.
//   dk, dv [B, Hkv, Skv, D] bf16, written by the dk/dv kernel, every row
//         below Skv (rows of keys at or beyond kv_valid get exact zeros), so
//         the caller allocates them uninitialised.
//
// With c = scale * log2(e):  p  = exp2(c * q.k - lse * log2(e)), 0 where the
// key is at or beyond kv_valid or (causal, Sq == Skv) after the query;
//   dp = do . v       ds = p * (dp - delta)
//   dq = scale * ds k     dk = scale * ds^T q     dv = p^T do
//
// Design. One block at a time on an SM; every load is a TMA box of
// [rows][64] bf16 in the 128-byte swizzle (D = 64, 128) or [rows][32] in the
// 64-byte swizzle (D = 96; `Layout` in hopper.cuh, which the forward
// shares), completing on an mbarrier ("full"), ring stages refilled when
// every consumer warp has released them ("empty"). The tensor maps are encoded on the host per call
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so nothing links
// libcuda). Their row extents are Sq for q, out and dout and kv_valid for k
// and v, so TMA zero-fills the rows of a ragged tile and a garbage tail past
// kv_valid never reaches a sum through 0 * inf; the stores' extents Sq and
// Skv clip what lies beyond. Consumer warpgroups of 64 rows run every
// product on the tensor cores as wgmma with fp32 accumulation: the
// score-like products SS (both operands K-major in shared memory), the
// gradient products RS (A = p or ds from the registers of the product
// before, rounded to bf16 in place; B read untransposed through the MN-major
// descriptor, as the forward's P V reads V).
//
//   dq: one block per (q tile, q head, batch), q tiles of 128 rows at
//       D = 128 (two consumers) and 192 at D = 64 and 96 (three), and a
//       producer warpgroup (setmaxnreg 24) whose first thread loads the
//       block's Q, dO and O tiles once, then K and V tiles of 64 keys through
//       a ring of 2 (4 at D = 96).
//       First the consumers compute delta = rowsum(dO * O) in fp32 from the
//       shared-memory tiles (the four threads of a row each sum a quarter of
//       it) and write it out for the dk/dv kernel; their rows' lse and delta
//       stay in registers. Per K/V tile: S = Q K^T and dP = dO V^T (SS,
//       m64n64), ds = p * (dp - delta) in registers, dQ += dS K (RS, m64nD,
//       K MN-major). Tile t's S and dP are issued before tile t-1's dQ
//       product, and tile t's elementwise step runs while that product is in
//       flight. Causal blocks stop at the diagonal and run the q tiles in
//       reverse, the longest first. The epilogue writes scale * dQ in bf16
//       into the warpgroup's own Q rows and stores them by TMA.
//   dk/dv: one block per (128-key tile, kv head, batch), two consumers of 64
//       keys that hold dK and dV in registers. The ring (3 stages) carries,
//       for each query head of the group and each of its q tiles of 64 rows
//       (from the diagonal on, under the causal mask), a Q and a dO tile and
//       the rows' lse and delta; K and V are loaded once. Per q tile: S^T =
//       K Q^T and dP^T = V dO^T (SS, m64n64), so the keys are the
//       accumulator rows; p and ds in fp32 registers; then dV += P^T dO and
//       dK += dS^T Q (RS, dO and Q MN-major). dK and dV are summed over the
//       group in fp32 registers in a fixed order: no atomics, no per-head
//       temporaries, the same bits from run to run. (The Pallas kernel emits
//       dk/dv per query head in fp32 and sums the group outside,
//       `:637-638`.) The epilogue writes dK (times scale) and dV in bf16
//       through the warpgroup's own K and V rows and stores them by TMA.
//       Registers decide the block: the consumers need 163 a thread at
//       D = 64 and 233 at D = 128 (nvcc -Xptxas -v, CUDA 12.8). A launch of
//       384 threads holds every thread to 168: ptxas spilled 270-400 bytes
//       and serialized the wgmmas at D = 128 whatever setmaxnreg split was
//       asked for. So at D = 128 the block is the two consumers alone (256
//       threads, 255 registers), and the first consumer warp feeds the ring
//       between its own tiles (lane 0 issues the TMA loads; the warp copies
//       lse and delta with cp.async, which arrives on the same mbarrier).
//       At D = 64 a producer warpgroup fits beside them and runs ahead, which
//       measured 1.11-1.12x faster at the 2B ViT's shape. D = 96's consumers
//       need 193 / 204 registers (not causal / causal), so it is laid out as
//       D = 128: with a producer warpgroup ptxas spilled 24-80 bytes and the
//       kernel ran 1.29x slower.
// Head dims: 64, 96 (Phi-3-mini, InternVL2-4B's decoder) and 128, each its
// own instantiation. At D = 96 a tile row is three boxes of 32 columns in
// the 64-byte swizzle, 192 bytes, so nothing is padded: the score products
// S and dP run D / 16 = 6 k16 steps, the gradient products dQ += dS K,
// dV += P^T dO and dK += dS^T Q run at N = 96 (m64n96k16, B MN-major over
// three 32-wide column blocks), so their accumulators are 48 registers a
// thread, not 64, and shared memory holds 96 columns. (Run on the D = 128
// body over tensor maps of extent 96, a quarter of every product would
// multiply TMA's zero fill.) The dq kernel spends what that frees on its
// ring: three consumers' Q, dO and O tiles (108 KB) beside 4 K/V stages
// (96 KB), which a 128-byte-swizzled layout of 128 columns could not hold.
// The scale comes from the caller (96^-0.5).
//
// Keys at or beyond kv_valid have p masked to exactly 0, so their dk and dv
// rows are exactly 0; a warpgroup or block that holds only such keys runs no
// product and stores zeros.
//
// Numerics. The Pallas kernels keep do, v, p and ds in fp32 for dp, dv and
// dk. wgmma takes bf16 operands, so here p is rounded to bf16 before p^T do
// and ds before ds k and ds^T q; do and v are bf16 as given. The plain
// versions (`plain_flash_attention_bwd`, `plain_attention_qkv_bwd`) round at
// the same two places. delta sums exact bf16 x bf16 products in fp32, in
// another order than the plain expression.
//
// What bounds them. Operations: dq is three products (6*B*H*Sq*Skv*D FLOP,
// half under the causal mask), dk/dv four (8*B*H*Sq*Skv*D), against a few
// hundred MB of tiles, far above the H100's ~295 bf16 FLOP/byte. So the bound
// is the tensor-core rate. On an H100 80GB HBM3 at 700 W these kernels
// reached 36-45% (dq) and 37-47% (dk/dv) of it at the training paths'
// shapes, 2.0-3.0x the mma.sync kernels they replace with delta included,
// and at Phi-3's [2, 32 / 32, 2113, 96] causal 44% (dq) and 37% (dk/dv),
// 0.96x SDPA's backward (tools/attention_bwd_ab.py, PERF.md). Open: each q
// tile of dk/dv runs its products and its elementwise step in turn (a second
// set of scores to overlap them took the registers past what the products
// need at D = 128; at D = 96, issued into the registers the fragments were
// packed from, it made ptxas serialize every wgmma, and both ran slower),
// the dq kernel's 64-key K/V tiles, and the padded last tiles of
// kv_valid = 1025 (one key in the last 64- or 128-key tile).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int WG_ROWS = 64;  // rows (dq: q rows; dk/dv: keys) of one consumer warpgroup
constexpr int BN = 64;       // dq: keys per K/V tile
constexpr int BQ = 64;       // dk/dv: q rows per Q/dO tile
constexpr float LOG2E = 1.4426950408889634f;

// The dq kernel's K/V ring: 4 stages at D = 96, where the 64-byte swizzle's
// smaller tiles leave room for them beside three consumers' Q, dO and O, else
// 2. At Phi-3's training shape on an H100 (tools/attention_bwd_ab.py) the
// D = 96 dq took 0.272 ms with two consumers and 2 stages, 0.198 with 3; with
// three consumers 0.246 / 0.194 / 0.188 with 2 / 3 / 4. The dk/dv kernel's
// Q/dO ring: 3 stages (4 measured the same at D = 96).
__host__ __device__ constexpr int dq_stages(int D) { return D == 96 ? 4 : 2; }
constexpr int DKV_STAGES = 3;

// Consumer warpgroups: the dq kernel three at D = 64 and 96 (q tiles of 192
// rows; at 512 threads ptxas holds each to 128 registers, which D = 96's
// 48-register dQ fits without a spill) and two at D = 128 (128 rows), as the
// forward; the dk/dv kernel two at every D (128 keys). setmaxnreg hands the
// producer's registers to the consumers; the split fills the 65536 registers
// the launch allots: 128 * (24 + 3 * 160) = 128 * (24 + 2 * 240) =
// 128 * (40 + 2 * 232) = 64512.
__host__ __device__ constexpr int dq_consumers(int D) { return D == 128 ? 2 : 3; }
constexpr int DKV_CONSUMERS = 2;
constexpr int BKV = WG_ROWS * DKV_CONSUMERS;  // keys per dk/dv block
// The dk/dv consumers need 163 registers a thread at D = 64, 193-204 at
// D = 96 and 233 at D = 128. At D = 64 a producer warpgroup fits beside them
// (384 threads, at most 168 registers each) and runs ahead of them; at D = 96
// and 128 the block is the two consumers alone (256 threads, at most 255) and
// their first warp feeds the ring between its own tiles.
__host__ __device__ constexpr bool dkv_producer_wg(int D) { return D == 64; }
__host__ __device__ constexpr int dkv_threads(int D) {
  return 128 * (DKV_CONSUMERS + (dkv_producer_wg(D) ? 1 : 0));
}

// ----------------------------------------------------------------- helpers --

struct Strides {
  long long batch, head, row;  // in elements; D is contiguous
};

// lse in base-2 units for the exponent; +inf where p must be 0 (a row the
// forward found no valid key for)
__device__ __forceinline__ float lse_to_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * LOG2E;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A descriptor the compiler cannot hoist out of a loop: rebuilt where it is
// used, it costs two registers instead of one pair per k16 step held live
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// What k16 step kk adds to the descriptor of a K-major operand whose tile of
// `rows` rows is stored as Layout<D>'s boxes (in units of 16 bytes): 16
// columns, 32 bytes, into box 16 kk / COLS
template <int D>
__host__ __device__ constexpr uint32_t kstep(int rows, int kk) {
  using L = Layout<D>;
  return static_cast<uint32_t>(((kk * 16 / L::COLS) * rows * L::ROW + (kk * 16 % L::COLS) * 2) >>
                               4);
}

// ... and of an MN-major operand: 16 rows
template <int D>
__host__ __device__ constexpr uint32_t mnstep(int kk) {
  return static_cast<uint32_t>((kk * 16 * Layout<D>::ROW) >> 4);
}

template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&acc)[D / 2], const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (D == 128)
    wgmma_rs_n128_mn(acc, a, b);
  else if constexpr (D == 96)
    wgmma_rs_n96_mn(acc, a, b);
  else
    wgmma_rs_n64_mn(acc, a, b);
}

// the m64n64 accumulator as the bf16 A fragments of 4 k16 steps: two
// neighbouring 8-column blocks are one step's fragment
__device__ __forceinline__ void pack_frags(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    f[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// `acc` (the m64nD accumulator of this warpgroup, times `mul`) in bf16 into
// `rows` [64][D] of a swizzled tile of `tile_rows` rows, in the layout of the
// store maps' [64][COLS] boxes
template <int D>
__device__ __forceinline__ void stage_out(unsigned char* rows, int tile_rows,
                                          const float (&acc)[D / 2], float mul) {
  using L = Layout<D>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = nb * 8 + (lane & 3) * 2;
    const int box = col / L::COLS, chunk = (col % L::COLS) / 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + lane / 4 + half * 8;
      unsigned char* dst = rows + box * tile_rows * L::ROW + L::at(row, chunk) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(acc[nb * 4 + half * 2] * mul, acc[nb * 4 + half * 2 + 1] * mul);
    }
  }
}

// Blocks start in the order of the grid's fastest index. Without the causal
// mask a head's tiles are the fastest, so that blocks running together share
// the head's K and V (dq) or Q and dO (dk/dv) in L2: with the heads fastest
// the dq kernel took 1.2-1.4x as long. Under the causal mask the tiles are the
// slowest, so that the heaviest tiles of every head start first and no heavy
// block starts last: the dk/dv kernel at internlm2-chat-20b's 2 x 8 kv heads
// took 0.66x as long (tools/attention_bwd_ab.py).
struct GridPos {
  int tile, head, batch;
};

__device__ __forceinline__ GridPos grid_pos(bool causal) {
  return causal ? GridPos{static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.x),
                          static_cast<int>(blockIdx.y)}
                : GridPos{static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.y),
                          static_cast<int>(blockIdx.z)};
}

dim3 make_grid(bool causal, int tiles, int heads, int B) {
  return causal ? dim3(heads, B, tiles) : dim3(tiles, heads, B);
}

// ------------------------------------------------------------------- dq ---

// Shared memory of one dq block, in bytes from a 1024-byte aligned base: Q,
// dO and O as Layout<D>'s boxes of [BM rows][COLS], each K and V stage as
// boxes of [BN rows][COLS], then the barriers.
template <int D>
struct DqSmem {
  static constexpr int BM = WG_ROWS * dq_consumers(D);
  static constexpr int STAGES = dq_stages(D);
  static constexpr int TILE = BM * D * 2;
  static constexpr int KV = BN * D * 2;
  static constexpr int DO_OFF = TILE;
  static constexpr int O_OFF = 2 * TILE;
  static constexpr int K_OFF = 3 * TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

struct DqBars {
  uint64_t* q_full;    // Q, dO and O
  uint64_t* kv_full;   // [STAGES]
  uint64_t* kv_empty;  // [STAGES]
};

struct DqArgs {
  const float* lse;
  float* delta;
  int hq, Sq, kv_valid, group;
  float scale, scale_log2;
};

// One consumer warpgroup: delta and the dq of 64 q rows against every K/V
// tile of the block.
template <int D, bool CAUSAL>
__device__ __forceinline__ void dq_consumer(unsigned char* smem, DqBars bar,
                                            const CUtensorMap* tdq, const DqArgs& a, int c,
                                            int q0, int h, int b, int n_tiles) {
  using S = DqSmem<D>;
  using L = Layout<D>;
  constexpr int BM = S::BM, STAGES = S::STAGES;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, tq = lane & 3;
  const int qw0 = q0 + c * WG_ROWS;           // this warpgroup's first row
  const int r0 = qw0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  unsigned char* sQ = smem;
  const unsigned char* sdO = smem + S::DO_OFF;
  const unsigned char* sO = smem + S::O_OFF;
  const unsigned char* sK = smem + S::K_OFF;
  const unsigned char* sV = smem + S::V_OFF;

  // delta = rowsum(dO * O) in fp32: the four threads of a row group each sum
  // every fourth 16-byte chunk of the row, then shuffle
  mbar_wait(bar.q_full, 0);
  float dl[2], lse2[2];
  const long long stat = (static_cast<long long>(b) * a.hq + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = c * WG_ROWS + warp * 16 + lane / 4 + i * 8;  // in the tile
    float acc = 0.f;
#pragma unroll
    for (int ch = tq; ch < D / 8; ch += 4) {
      const int off = (ch / (L::COLS / 8)) * BM * L::ROW + L::at(row, ch % (L::COLS / 8));
      const uint4 x = *reinterpret_cast<const uint4*>(sdO + off);
      const uint4 y = *reinterpret_cast<const uint4*>(sO + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
        const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[j]));
        acc = fmaf(u.x, w.x, acc);
        acc = fmaf(u.y, w.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffff, acc, 1);
    acc += __shfl_xor_sync(0xffffffff, acc, 2);
    dl[i] = acc;
    const int r = r0 + i * 8;
    lse2[i] = r < a.Sq ? lse_to_log2(a.lse[stat + r]) : INFINITY;
    if (tq == 0 && r < a.Sq) a.delta[stat + r] = acc;
  }

  float s[BN / 2], dp[BN / 2], dq[D / 2];
  uint32_t dsf[BN / 16][4];
  zero(dq);

  const unsigned char* qa = sQ + c * WG_ROWS * L::ROW;
  const unsigned char* da = sdO + c * WG_ROWS * L::ROW;
  // S = Q K^T and dP = dO V^T, both operands K-major: D / 16 k16 steps
  auto issue_sdp = [&](int st) {
    const uint64_t qd = opaque(L::desc(qa, 16));
    const uint64_t dd = opaque(L::desc(da, 16));
    const uint64_t kd = opaque(L::desc(sK + st * S::KV, 16));
    const uint64_t vd = opaque(L::desc(sV + st * S::KV, 16));
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, qd + kstep<D>(BM, kk), kd + kstep<D>(BN, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, dd + kstep<D>(BM, kk), vd + kstep<D>(BN, kk), kk > 0);
    wgmma_commit();
  };
  // dQ += dS K, K read MN-major (16 keys per k16 step), N = D
  auto issue_dq = [&](int st) {
    const uint64_t km = opaque(L::desc(sK + st * S::KV, BN * L::ROW));
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_d<D>(dq, dsf[kk], km + mnstep<D>(kk));
    wgmma_commit();
  };
  // ds = p * (dp - delta) of tile t, in place of s
  auto grad = [&](int t) {
    const int k0 = t * BN;
    const bool need_mask = k0 + BN > a.kv_valid || (CAUSAL && k0 + BN - 1 > qw0);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[nb * 4 + e], a.scale_log2, -lse2[e >> 1]));
        if (need_mask) {
          const int col = k0 + nb * 8 + tq * 2 + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          if (col >= a.kv_valid || (CAUSAL && col > row)) p = 0.f;
        }
        s[nb * 4 + e] = p * (dp[nb * 4 + e] - dl[e >> 1]);
      }
    }
  };
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(bar.kv_empty + st);  // one arrival per warp
  };

  mbar_wait(bar.kv_full, 0);
  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grad(0);
  pack_frags(s, dsf);
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % STAGES, pst = (t - 1) % STAGES;
    mbar_wait(bar.kv_full + st, (t / STAGES) & 1);
    issue_sdp(st);
    issue_dq(pst);
    wgmma_wait<1>();  // S and dP of tile t
    fence_regs(s);
    fence_regs(dp);
    grad(t);
    wgmma_wait<0>();  // dQ of tile t - 1
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) fence_regs(dsf[kk]);
    release(pst);
    pack_frags(s, dsf);
  }
  issue_dq((n_tiles - 1) % STAGES);
  wgmma_wait<0>();
  fence_regs(dq);

  // scale * dQ in bf16 into this warpgroup's Q rows (read for the last time
  // above), then one TMA store per box; rows at or beyond Sq are not written
  unsigned char* so = sQ + c * WG_ROWS * L::ROW;
  stage_out<D>(so, BM, dq, a.scale);
  fence_proxy_async();
  named_barrier_sync(1 + c, 128);
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < L::BOXES; ++j)
      tma_store_4d(tdq, so + j * BM * L::ROW, j * L::COLS, qw0, h, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(128 * (dq_consumers(D) + 1), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdq,
                    const DqArgs a) {
  using S = DqSmem<D>;
  using L = Layout<D>;
  constexpr int BM = S::BM, STAGES = S::STAGES;
  constexpr int CONSUMERS = dq_consumers(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  DqBars bar;
  bar.q_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  bar.kv_full = bar.q_full + 1;
  bar.kv_empty = bar.kv_full + STAGES;

  // causal q tiles in reverse, the longest first
  const GridPos pos = grid_pos(CAUSAL);
  const int q_tile = CAUSAL ? gridDim.z - 1 - pos.tile : pos.tile;
  const int q0 = q_tile * BM;
  const int h = pos.head, b = pos.batch;
  const int active = min(CONSUMERS, (a.Sq - q0 + WG_ROWS - 1) / WG_ROWS);
  int n_tiles = (a.kv_valid + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (min(q0 + BM, a.Sq) - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar.kv_full + s, 1);
      mbar_init(bar.kv_empty + s, 4 * active);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / a.group;
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tdo);
      prefetch_tensormap(&to);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      mbar_arrive_expect_tx(bar.q_full, 3 * S::TILE);
      for (int j = 0; j < L::BOXES; ++j) {
        const int col = j * L::COLS, off = j * BM * L::ROW;
        tma_load_4d(smem + off, &tq, bar.q_full, col, q0, h, b);
        tma_load_4d(smem + S::DO_OFF + off, &tdo, bar.q_full, col, q0, h, b);
        tma_load_4d(smem + S::O_OFF + off, &to, bar.q_full, col, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(bar.kv_empty + st, ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar.kv_full + st, 2 * S::KV);
        for (int j = 0; j < L::BOXES; ++j) {
          const int col = j * L::COLS, off = st * S::KV + j * BN * L::ROW;
          tma_load_4d(smem + S::K_OFF + off, &tk, bar.kv_full + st, col, t * BN, kvh, b);
          tma_load_4d(smem + S::V_OFF + off, &tv, bar.kv_full + st, col, t * BN, kvh, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMERS == 3 ? 160 : 240>();
    const int c = wg - 1;
    if (c < active) dq_consumer<D, CAUSAL>(smem, bar, &tdq, a, c, q0, h, b, n_tiles);
  }
}

// ---------------------------------------------------------------- dk/dv ---

// Shared memory of one dk/dv block: K and V as Layout<D>'s boxes of [BKV
// rows][COLS], each ring stage a Q and a dO tile of boxes of [BQ rows][COLS],
// the stages' lse and delta, then the barriers.
template <int D>
struct DkvSmem {
  static constexpr int STAGES = DKV_STAGES;
  static constexpr int KV = BKV * D * 2;
  static constexpr int QT = BQ * D * 2;
  static constexpr int V_OFF = KV;
  static constexpr int Q_OFF = 2 * KV;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT;
  static constexpr int STAT_OFF = DO_OFF + STAGES * QT;  // [STAGES][2][BQ] fp32
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

struct DkvBars {
  uint64_t* kv_full;  // K and V
  uint64_t* full;     // [STAGES]: Q and dO (TMA) and the stats (32 cp.async arrivals)
  uint64_t* empty;    // [STAGES]
};

struct DkvArgs {
  const float* lse;
  const float* delta;
  int hq, Sq, kv_valid, group;
  float scale, scale_log2;
};

// One block per (BKV-key tile, kv head, batch): two consumer warpgroups of 64
// keys, which hold dK and dV of their keys in registers, and at D = 64 a
// producer warpgroup (dkv_producer_wg). The feeding warp (the producer's
// first warp, or the first consumer's) loads the ring: its lane 0 issues the
// TMA loads, and its lanes copy each q tile's lse and delta with cp.async,
// zeros past Sq (where Q and dO are zero-filled too, so those rows add
// nothing).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(dkv_threads(D), 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                     const DkvArgs a) {
  using S = DkvSmem<D>;
  using L = Layout<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  DkvBars bar;
  bar.kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  bar.full = bar.kv_full + 1;
  bar.empty = bar.full + STAGES;

  const GridPos pos = grid_pos(CAUSAL);
  const int k0 = pos.tile * BKV;  // causal: tile 0 is the heaviest
  const int kvh = pos.head, b = pos.batch;
  // consumer warpgroups that hold a valid key (warpgroup 0 whenever any
  // does); a block with none loads nothing and stores zeros
  const int active = max(0, min(DKV_CONSUMERS, (a.kv_valid - k0 + WG_ROWS - 1) / WG_ROWS));
  const int first_q_tile = CAUSAL ? k0 / BQ : 0;
  const int n_q = (a.Sq + BQ - 1) / BQ - first_q_tile;
  const int n_items = active > 0 ? a.group * n_q : 0;  // (query head, q tile) pairs

  constexpr bool PRODUCER = dkv_producer_wg(D);
  const int c = threadIdx.x / 128 - (PRODUCER ? 1 : 0);  // consumer warpgroup, -1: producer
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, quad = lane & 3;
  const bool feeder = threadIdx.x < 32;  // warp 0 of the block

  if (threadIdx.x == 0) {
    mbar_init(bar.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar.full + s, 1 + 32);  // the TMA thread's arrival and 32 cp.async ones
      mbar_init(bar.empty + s, 4 * max(active, 1));  // one arrival per active consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // item j into stage j % STAGES, which is free: the Q and dO tiles of its
  // query head and q tile, and their rows' lse and delta
  auto load_item = [&](int j) {
    const int st = j % STAGES;
    const int h = kvh * a.group + j / n_q, q0 = (first_q_tile + j % n_q) * BQ;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar.full + st, 2 * S::QT);
      for (int jb = 0; jb < L::BOXES; ++jb) {
        const int col = jb * L::COLS, off = st * S::QT + jb * BQ * L::ROW;
        tma_load_4d(smem + S::Q_OFF + off, &tq, bar.full + st, col, q0, h, b);
        tma_load_4d(smem + S::DO_OFF + off, &tdo, bar.full + st, col, q0, h, b);
      }
    }
    float* stats = reinterpret_cast<float*>(smem + S::STAT_OFF) + st * 2 * BQ;
    const long long at = (static_cast<long long>(b) * a.hq + h) * a.Sq;
#pragma unroll
    for (int r = lane; r < BQ; r += 32) {
      const bool in = q0 + r < a.Sq;
      const long long row = at + (in ? q0 + r : 0);
      cp_async_4(stats + r, a.lse + row, in);
      cp_async_4(stats + BQ + r, a.delta + row, in);
    }
    cp_async_mbar_arrive(bar.full + st);
    __syncwarp();  // converged again before the warpgroup's next wgmma
  };
  if (feeder && n_items > 0) {
    if (lane == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tdo);
      mbar_arrive_expect_tx(bar.kv_full, 2 * S::KV);
      for (int jb = 0; jb < L::BOXES; ++jb) {
        const int col = jb * L::COLS, off = jb * BKV * L::ROW;
        tma_load_4d(smem + off, &tk, bar.kv_full, col, k0, kvh, b);
        tma_load_4d(smem + S::V_OFF + off, &tv, bar.kv_full, col, k0, kvh, b);
      }
    }
    for (int j = 0; j < min(STAGES, n_items); ++j) load_item(j);
    if (PRODUCER) {  // the producer runs ahead, each stage as soon as it is free
      for (int j = STAGES; j < n_items; ++j) {
        mbar_wait(bar.empty + j % STAGES, ((j / STAGES) & 1) ^ 1);
        load_item(j);
      }
    }
  }
  if (c < 0) return;

  const int kw0 = k0 + c * WG_ROWS;             // this warpgroup's first key
  const int key0 = kw0 + warp * 16 + lane / 4;  // this thread's keys: key0 and key0 + 8
  unsigned char* ka = smem + c * WG_ROWS * L::ROW;
  unsigned char* va = smem + S::V_OFF + c * WG_ROWS * L::ROW;

  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  if (n_items > 0) mbar_wait(bar.kv_full, 0);
  if (c < active) {
    float st_[BQ / 2], dpt[BQ / 2];
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
    for (int i = 0; i < n_items; ++i) {
      // refill the stage that item i - 1 used, once both warpgroups released it
      const int j = i + STAGES - 1;
      if (!PRODUCER && feeder && i > 0 && j < n_items) {
        mbar_wait(bar.empty + j % STAGES, ((j / STAGES) & 1) ^ 1);
        load_item(j);
      }
      const int st = i % STAGES;
      const unsigned char* sQ = smem + S::Q_OFF + st * S::QT;
      const unsigned char* sdO = smem + S::DO_OFF + st * S::QT;
      const float* lse = reinterpret_cast<const float*>(smem + S::STAT_OFF) + st * 2 * BQ;
      const float* dls = lse + BQ;
      const int q0 = (first_q_tile + i % n_q) * BQ;
      mbar_wait(bar.full + st, (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: D / 16 k16 steps
      const uint64_t kd = opaque(L::desc(ka, 16));
      const uint64_t vd = opaque(L::desc(va, 16));
      const uint64_t qd = opaque(L::desc(sQ, 16));
      const uint64_t od = opaque(L::desc(sdO, 16));
      fence_regs(st_);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st_, kd + kstep<D>(BKV, kk), qd + kstep<D>(BQ, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, vd + kstep<D>(BKV, kk), od + kstep<D>(BQ, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st_);
      fence_regs(dpt);

      // p (fp32) and ds = p * (dp - delta), then both in bf16 as A fragments
      const bool need_mask = kw0 + WG_ROWS > a.kv_valid || (CAUSAL && kw0 + WG_ROWS - 1 > q0);
#pragma unroll
      for (int nb = 0; nb < BQ / 8; ++nb) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse + nb * 8 + quad * 2);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + nb * 8 + quad * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = lse_to_log2((e & 1) ? l2.y : l2.x);
          float p = ex2(fmaf(st_[nb * 4 + e], a.scale_log2, -l));
          if (need_mask) {
            const int key = key0 + (e >> 1) * 8;
            const int row = q0 + nb * 8 + quad * 2 + (e & 1);
            if (key >= a.kv_valid || (CAUSAL && key > row)) p = 0.f;
          }
          st_[nb * 4 + e] = p;
          dpt[nb * 4 + e] = p * (dpt[nb * 4 + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      pack_frags(st_, pf);
      pack_frags(dpt, dsf);

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major, N = D
      const uint64_t om = opaque(L::desc(sdO, BQ * L::ROW));
      const uint64_t qm = opaque(L::desc(sQ, BQ * L::ROW));
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_d<D>(dv, pf[kk], om + mnstep<D>(kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_d<D>(dk, dsf[kk], qm + mnstep<D>(kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        fence_regs(pf[kk]);
        fence_regs(dsf[kk]);
      }
      if (lane == 0) mbar_arrive(bar.empty + st);  // one arrival per warp
    }
  }

  // dK (times scale) and dV in bf16 through this warpgroup's own K and V rows,
  // then TMA stores; rows at or beyond Skv are not written
  stage_out<D>(ka, BKV, dk, a.scale);
  stage_out<D>(va, BKV, dv, 1.f);
  fence_proxy_async();
  named_barrier_sync(1 + c, 128);
  if (tid == 0) {
#pragma unroll
    for (int jb = 0; jb < L::BOXES; ++jb) {
      tma_store_4d(&tdk, ka + jb * BKV * L::ROW, jb * L::COLS, kw0, kvh, b);
      tma_store_4d(&tdv, va + jb * BKV * L::ROW, jb * L::COLS, kw0, kvh, b);
    }
    tma_store_commit();
    tma_store_wait_read();
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

// everything an entry takes; the pointers an entry does not use may be null
struct Tensors {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, int threads, cudaStream_t stream,
                   const Args&... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Tensors& t, int B, int hq, int hkv, int Sq, int Skv, int kv_valid,
                      int causal, float scale, cudaStream_t stream) {
  using S = DqSmem<D>;
  CUtensorMap mq, mdo, mo, mk, mv, mdq;
  // a view TMA cannot describe (strides off 16 bytes, a base off 16 bytes)
  if (!make_map<D>(&mq, t.q, Sq, hq, B, t.qs, S::BM) ||
      !make_map<D>(&mdo, t.dout, Sq, hq, B, t.dos, S::BM) ||
      !make_map<D>(&mo, t.out, Sq, hq, B, t.os, S::BM) ||
      !make_map<D>(&mk, t.k, kv_valid, hkv, B, t.ks, BN) ||
      !make_map<D>(&mv, t.v, kv_valid, hkv, B, t.vs, BN) ||
      !make_map<D>(&mdq, t.dq, Sq, hq, B, t.dqs, WG_ROWS))
    return cudaErrorInvalidPitchValue;
  const DqArgs a{t.lse, t.delta, hq, Sq, kv_valid, hq / hkv, scale, scale * LOG2E};
  const dim3 grid = make_grid(causal, (Sq + S::BM - 1) / S::BM, hq, B);
  const int threads = 128 * (dq_consumers(D) + 1);
  return causal ? launch(flash_bwd_dq_kernel<D, true>, S::BYTES, grid, threads, stream, mq, mdo,
                         mo, mk, mv, mdq, a)
                : launch(flash_bwd_dq_kernel<D, false>, S::BYTES, grid, threads, stream, mq,
                         mdo, mo, mk, mv, mdq, a);
}

template <int D>
cudaError_t launch_dkv(const Tensors& t, int B, int hq, int hkv, int Sq, int Skv, int kv_valid,
                       int causal, float scale, cudaStream_t stream) {
  using S = DkvSmem<D>;
  CUtensorMap mq, mdo, mk, mv, mdk, mdv;
  if (!make_map<D>(&mq, t.q, Sq, hq, B, t.qs, BQ) ||
      !make_map<D>(&mdo, t.dout, Sq, hq, B, t.dos, BQ) ||
      !make_map<D>(&mk, t.k, kv_valid, hkv, B, t.ks, BKV) ||
      !make_map<D>(&mv, t.v, kv_valid, hkv, B, t.vs, BKV) ||
      !make_map<D>(&mdk, t.dk, Skv, hkv, B, t.dks, WG_ROWS) ||
      !make_map<D>(&mdv, t.dv, Skv, hkv, B, t.dvs, WG_ROWS))
    return cudaErrorInvalidPitchValue;
  const DkvArgs a{t.lse, t.delta, hq, Sq, kv_valid, hq / hkv, scale, scale * LOG2E};
  const dim3 grid = make_grid(causal, (Skv + BKV - 1) / BKV, hkv, B);
  const int threads = dkv_threads(D);
  return causal ? launch(flash_bwd_dkv_kernel<D, true>, S::BYTES, grid, threads, stream, mq, mdo,
                         mk, mv, mdk, mdv, a)
                : launch(flash_bwd_dkv_kernel<D, false>, S::BYTES, grid, threads, stream, mq,
                         mdo, mk, mv, mdk, mdv, a);
}

// Checks what the kernels rely on and picks the instantiation.
template <bool DKV>
int dispatch(const Tensors& t, int B, int hq, int hkv, int Sq, int Skv, int D, int kv_valid,
             int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || hkv <= 0 || hq % hkv != 0 || kv_valid <= 0 ||
      kv_valid > Skv || (causal && Sq != Skv) || (D != 64 && D != 96 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  // grids are (tiles of at least 64 rows, heads, batch) or (heads, batch, tiles)
  if (B > 65535 || hq > 65535 || (max(Sq, Skv) + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto d) {
    constexpr int HD = decltype(d)::value;
    return DKV ? launch_dkv<HD>(t, B, hq, hkv, Sq, Skv, kv_valid, causal, scale, st)
               : launch_dq<HD>(t, B, hq, hkv, Sq, Skv, kv_valid, causal, scale, st);
  };
  const cudaError_t err = D == 64   ? run(std::integral_constant<int, 64>())
                          : D == 96 ? run(std::integral_constant<int, 96>())
                                    : run(std::integral_constant<int, 128>());
  return static_cast<int>(err);
}

using bf16 = __nv_bfloat16;

// The fused array: q, k, v and dq, dk, dv are head ranges of qkv and dqkv.
Tensors fused(const void* qkv, const void* out, const void* dout, const void* lse, void* delta,
              void* dqkv, int hq, int hkv, const long long* s) {
  const auto* q = static_cast<const bf16*>(qkv);
  auto* g = static_cast<bf16*>(dqkv);
  const Strides in{s[0], s[1], s[2]}, grad{s[9], s[10], s[11]};
  return Tensors{q, q + hq * in.head, q + (hq + hkv) * in.head, out, dout,
                 static_cast<const float*>(lse), static_cast<float*>(delta), g,
                 g + hq * grad.head, g + (hq + hkv) * grad.head, in, in, in,
                 Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]}, grad, grad, grad};
}

// Three tensors: strides[0..2] q's, [3..5] k's, [6..8] v's, [9..11] out's,
// [12..14] dout's, [15..17] dq's, [18..20] dk's, [21..23] dv's.
Tensors separate(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 const void* lse, void* delta, void* dq, void* dk, void* dv,
                 const long long* s) {
  return Tensors{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                 dq, dk, dv, Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
                 Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
                 Strides{s[12], s[13], s[14]}, Strides{s[15], s[16], s[17]},
                 Strides{s[18], s[19], s[20]}, Strides{s[21], s[22], s[23]}};
}

}  // namespace

extern "C" {

// All return 0 on success, else the cudaError_t of the failed launch
// (cudaErrorInvalidPitchValue: a view TMA cannot describe). Shapes, dtypes,
// strides and alignment are checked by the Python wrappers. Strides are in
// elements, for (batch, head, row). The dq entries read q, k, v, out, dout
// and lse and write delta and dq; the dk/dv entries read q, k, v, dout, lse
// and delta and write dk and dv. What an entry does not use may be null.

// The fused array: strides[0..2] qkv's, [3..5] out's, [6..8] dout's, [9..11]
// dqkv's. The dq entry writes heads [0, Hq) of dqkv, the dk/dv entry heads
// [Hq, Hq + 2*Hkv).
int aigv_flash_attn_qkv_bwd_dq(const void* qkv, const void* out, const void* dout,
                               const void* lse, void* delta, void* dqkv, int B, int hq, int hkv,
                               int S, int D, int kv_valid, int causal, const long long* strides,
                               float scale, void* stream) {
  return dispatch<false>(fused(qkv, out, dout, lse, delta, dqkv, hq, hkv, strides), B, hq, hkv,
                         S, S, D, kv_valid, causal, scale, stream);
}

int aigv_flash_attn_qkv_bwd_dkv(const void* qkv, const void* out, const void* dout,
                                const void* lse, void* delta, void* dqkv, int B, int hq, int hkv,
                                int S, int D, int kv_valid, int causal, const long long* strides,
                                float scale, void* stream) {
  return dispatch<true>(fused(qkv, out, dout, lse, delta, dqkv, hq, hkv, strides), B, hq, hkv,
                        S, S, D, kv_valid, causal, scale, stream);
}

// Three tensors, with the 24 strides of `separate`.
int aigv_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const void* lse, void* delta, void* dq, void* dk,
                           void* dv, int B, int hq, int hkv, int Sq, int Skv, int D, int kv_valid,
                           int causal, const long long* strides, float scale, void* stream) {
  return dispatch<false>(separate(q, k, v, out, dout, lse, delta, dq, dk, dv, strides), B, hq,
                         hkv, Sq, Skv, D, kv_valid, causal, scale, stream);
}

int aigv_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* out,
                            const void* dout, const void* lse, void* delta, void* dq, void* dk,
                            void* dv, int B, int hq, int hkv, int Sq, int Skv, int D,
                            int kv_valid, int causal, const long long* strides, float scale,
                            void* stream) {
  return dispatch<true>(separate(q, k, v, out, dout, lse, delta, dq, dk, dv, strides), B, hq,
                        hkv, Sq, Skv, D, kv_valid, causal, scale, stream);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
