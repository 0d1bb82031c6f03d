// Flash-attention backward for sm_90a (Hopper), over separate q, k, v tensors,
// with two entry points over one kernel (and a small pass on either side).
//
// Replaces the two Pallas TPU kernels of `_bwd` in
// aigv_assessor_tpu/ops/pallas_attention.py, `_bwd_dq_kernel` (:384, called
// at :602) and `_bwd_dkv_kernel` (:455, called at :618), by one kernel that
// computes what the pair computes: flash_bwd_kernel (dk, dv and dQ's sums),
// between flash_bwd_delta_kernel (delta) and flash_bwd_dq_convert_kernel
// (dq), as both of their callers reach them:
// - `aigv_flash_attn_qkv_bwd`: off one fused head-major qkv array
//   (`flash_attention_qkv`'s custom_vjp, `_flash_qkv_bwd`), gradients into
//   one dqkv array of the same layout: K3a / K3b, which stage-2 training runs
//   in both towers of InternVL2-2B and in the decoder of InternVL2-26B.
// - `aigv_flash_attn_bwd`: on three separate tensors (`flash_attention`'s
//   custom_vjp, `_flash_bwd`), `bshd` or `bhsd`, Sq and Skv free when not
//   causal: K2's backward, which the QK-normalized ViT of InternVL2-26B runs
//   in training.
//
//   q     [B, Hq, Sq, D] bf16 (or any layout): each of q, k, v, out, dout, dq,
//         dk and dv is read or written through its own (batch, head, row)
//         strides, D contiguous, the other strides multiples of 16 bytes and
//         a 16-byte aligned base (what a TMA tensor map can describe), so
//         slices and permuted views of a projection output need no copy. The
//         fused entry passes pointers into one array, heads ordered
//         [q | k | v]. q head h reads kv head h / G, G = Hq / Hkv.
//   k, v  [B, Hkv, Skv, D] bf16.
//   out, dout [B, Hq, Sq, D] bf16: the forward's output and its gradient.
//   lse   [B, Hq, Sq] fp32 contiguous, the forward's logsumexp in natural-log
//         units; -inf marks a row with no valid key, whose p is 0 here.
//   delta [B, Hq, Sq] fp32 contiguous, rowsum(dout * out) summed in fp32,
//         written by the first launch.
//   dq    [B, Hq, Sq, D] bf16, every row below Sq.
//   dk, dv [B, Hkv, Skv, D] bf16, every row below Skv (rows of keys at or
//         beyond kv_valid get exact zeros), so the caller allocates the
//         gradients uninitialised.
//   dq_acc, counters: the call's workspace (see the entries): dQ's fp32
//         running sums, 64 x D floats per q tile (2x dq's bytes), and one
//         counter per q tile.
//
// With c = scale * log2(e):  p  = exp2(c * q.k - lse * log2(e)), 0 where the
// key is at or beyond kv_valid or (causal, Sq == Skv) after the query;
//   dp = do . v       ds = p * (dp - delta)
//   dq = scale * ds k     dk = scale * ds^T q     dv = p^T do
//
// Design. The Pallas pair computes S = QK^T and dP = dO V^T twice for every
// (query, key) pair, once per kernel: seven products where a backward needs
// five (S, dP, dV, dK, dQ). Here one block per (128-key tile, kv head, batch)
// computes all five: three launches, delta (flash_bwd_delta_kernel), the
// block's products (flash_bwd_kernel), and dq from dQ's running sums
// (flash_bwd_dq_convert_kernel).
//   flash_bwd_kernel: a producer warpgroup and two consumer warpgroups of 64
// keys (setmaxnreg 24 / 240, as the forward). K and V are loaded once; the
// producer's first warp runs ahead on a ring (3 stages, 2 at D = 128) that
// carries, for each query head of the group and each of its q tiles of 64
// rows (from the diagonal on, under the causal mask), a Q and a dO tile and
// the rows' lse and delta. Every load is a TMA box of [rows][64] bf16 in the
// 128-byte swizzle (D = 64, 128) or [rows][32] in the 64-byte swizzle (D =
// 96; `Layout` in hopper.cuh, which the forward shares). Per item a consumer
// runs S^T = K Q^T and dP^T = V dO^T (SS, m64n64, keys as accumulator rows),
// p and ds in fp32 registers, dV += P^T dO and dK += dS^T Q (RS, p and ds
// rounded to bf16 in place, dO and Q MN-major); dK and dV are summed over the
// group in fp32 registers in a fixed order. Each consumer also writes its
// dS^T rows (bf16) to one of two [128 keys][64 q] buffers, and dQ's share of
// the item, dS K over all 128 keys at N = D (SS, dS^T and K MN-major), is run
// one item later by one consumer, the two taking turns, beside its dV and dK
// products (at D = 128 after them: its 64 accumulators do not fit beside the
// p and ds fragments). mbarriers pass the dS^T buffers between the consumers
// and the fp32 shares (two buffers, the accumulator's fragment order) to the
// producer's second warp, the writer, so no warpgroup waits on another within
// an item.
//   dQ is summed over the key tiles in fp32 in a fixed order (`DqOrder`), so
// a second run gives the same bits: the writer copies the share into the q
// tile's running sum dq_acc if its key tile is first in that order, else adds
// it (one bulk fp32 reduction of 64 x D floats), after the q tile's counter
// reads its rank; the add is released (the counter incremented) as soon as
// its bulk group has landed, before the writer's next wait on a counter (so
// no two blocks wait on each other). A release deferred to the next item's
// share measured 0.1-1% slower. Under the causal mask the adds go by
// key tile, the grid's slowest index (the heaviest tiles of every head start
// first), and a block sweeps its q tiles from the last down to its diagonal.
// Without it a head's key tiles are the fastest index, the block of key tile
// t sweeps from q tile t * n_qt / n_kt round and the adds into a q tile go by
// the step at which each block reaches it, so the blocks of a head add into
// different q tiles at the same time.
//   flash_bwd_delta_kernel computes delta = rowsum(dO * O) in fp32 (16 lanes
// a row) and sets the counters to 0, so that the launches replay from a CUDA
// graph; flash_bwd_dq_convert_kernel reads each q tile's sums through shared
// memory and writes scale * dQ in bf16, 16 bytes a thread, through dq's
// strides.
// Head dims: 64, 96 (Phi-3-mini, InternVL2-4B's decoder) and 128, each its
// own instantiation. At D = 96 a tile row is three boxes of 32 columns in
// the 64-byte swizzle, 192 bytes, so nothing is padded: the score products
// run D / 16 = 6 k16 steps and the gradient products N = 96.
// The scale comes from the caller (D^-0.5).
//
// Keys at or beyond kv_valid have p masked to exactly 0, so their dk and dv
// rows are exactly 0; a warpgroup that holds only such keys runs no score or
// dV / dK product (its dS^T rows are zeros, written once), and a block with
// no valid key adds nothing and stores zeros.
//
// Numerics. The Pallas kernels keep do, v, p and ds in fp32 for dp, dv and
// dk. wgmma takes bf16 operands, so here p is rounded to bf16 before p^T do
// and ds before ds k and ds^T q; do and v are bf16 as given. The plain
// versions (`plain_flash_attention_bwd`, `plain_attention_qkv_bwd`) round at
// the same two places. dQ is an fp32 sum over key tiles in a fixed order.
// delta sums exact bf16 x bf16 products in fp32, in another order than the
// plain expression.
//
// What bounds it. Operations: five products, 10 * B * Hq * pairs * D FLOP
// (pairs = Sq * kv_valid, or S (S + 1) / 2 under the causal mask), against a
// few hundred MB of tiles and dQ's running sums, far above the H100's ~295
// bf16 FLOP/byte. So the bound is the tensor-core rate. On an H100 80GB HBM3
// at 700 W (tools/attention_bwd_ab.py, in turns with the earlier pair of
// kernels) the three launches reach 26.6-38.9% of it at the seven training
// shapes, 0.85-0.99x the pair's time, 0.95-1.00x SDPA's backward at the 2B
// decoder and InternViT-6B, 1.04x at the 20B decoder and 1.07x at the 2B ViT
// (D = 64). nvcc -Xptxas -v (CUDA 12.8): no spill at any D; the key tiles'
// kernel launches at 168 registers a thread, setmaxnreg 24 / 240.
//   Tried and dropped (same tool): dQ split by columns between the consumers,
// each product waiting for both dS^T halves (the consumers in lockstep) and
// the share added by the consumers' own thread (1.08-1.27x the pair); the
// split by keys with the shares summed in shared memory (1.4-1.7x); the last
// adder converting dq in the writer warp instead of the third launch (1.4x
// slower: one warp of 24 registers); items head by head instead of q tile by
// q tile (the causal blocks of a GQA head drift apart, and at the 20B
// decoder the order's waits cost 0.15 ms); sweep offsets rounded up; polls
// backed off; a 4-stage ring at D = 96 (does not fit).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int WG_ROWS = 64;    // keys of one consumer warpgroup
constexpr int BQ = 64;         // q rows of one item: a Q and a dO tile, one q tile of dQ
constexpr int CONSUMERS = 2;
constexpr int BKV = WG_ROWS * CONSUMERS;  // keys per block
constexpr float LOG2E = 1.4426950408889634f;
// Without the causal mask the blocks of a head start their sweeps over the q
// tiles at offsets spread over the sequence, so that they add into different
// q tiles at the same time; the order of the adds then puts a block before
// blocks of the same head with a higher index, which is free of deadlock
// while a head's blocks fit on the card beside those of the other heads in
// flight. Above this many key tiles the sweeps all start at q tile 0 and the
// adds go in the order of the key tiles, as launched.
constexpr int ROTATE_MAX_TILES = 32;

// A producer warpgroup (its first warp feeds the ring, its second the dQ sums)
// and two consumer warpgroups. setmaxnreg hands the producer's registers to
// the consumers, as in the forward: 128 * 24 + 256 * 240 = 64512 of the
// 65536 the launch allots.
constexpr int BLOCK_THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// The Q/dO ring: 3 stages, 2 at D = 128, where a third would not fit beside
// the two buffers of dS^T and of dQ's share.
__host__ __device__ constexpr int ring_stages(int D) { return D == 128 ? 2 : 3; }

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

template <int D>
__device__ __forceinline__ void wgmma_ss_d_tt(float (&acc)[D / 2], uint64_t a, uint64_t b,
                                              int scale_d) {
  if constexpr (D == 128)
    wgmma_ss_n128_tt(acc, a, b, scale_d);
  else if constexpr (D == 96)
    wgmma_ss_n96_tt(acc, a, b, scale_d);
  else
    wgmma_ss_n64_tt(acc, a, b, scale_d);
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
// mask a head's key tiles are the fastest, so that blocks running together
// share the head's Q and dO in L2. Under the causal mask the key tiles are
// the slowest, so that the heaviest tiles of every head start first and no
// heavy block starts last: the dk/dv kernel at internlm2-chat-20b's 2 x 8 kv
// heads took 0.66x as long (tools/attention_bwd_ab.py). Either way a block's
// predecessors in the order of the dQ adds (DqOrder) have started before it
// or belong to its own head.
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

// ------------------------------------------------------------------- delta --

// delta = rowsum(dout * out) in fp32 over the [B, Hq, Sq] rows, 16 lanes a
// row (each one 16-byte chunk of it, D / 8 of them busy), summed by shuffles;
// and the dQ order's counters set to 0 for the launch that follows.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* out, Strides os, const bf16* dout, Strides dos, float* delta,
                       int hq, int Sq, long long rows, int* counters, long long n_counters) {
  const long long gid = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  for (long long i = gid; i < n_counters; i += static_cast<long long>(gridDim.x) * 256)
    counters[i] = 0;
  const long long row = gid / 16;
  const int part = threadIdx.x % 16;
  float acc = 0.f;
  if (row < rows && part < D / 8) {
    const long long bh = row / Sq;
    const int r = static_cast<int>(row - bh * Sq), h = static_cast<int>(bh % hq);
    const long long b = bh / hq;
    const uint4 x = *reinterpret_cast<const uint4*>(out + b * os.batch + h * os.head +
                                                    r * os.row + part * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + b * dos.batch + h * dos.head +
                                                    r * dos.row + part * 8);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
      const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[j]));
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
  }
#pragma unroll
  for (int m = 8; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffff, acc, m);
  if (part == 0 && row < rows) delta[row] = acc;
}

// ------------------------------------------------------------ the backward --

// Shared memory of one block, in bytes from a 1024-byte aligned base: K and V
// as Layout<D>'s boxes of [BKV rows][COLS], each ring stage a Q and a dO tile
// of boxes of [BQ rows][COLS], two buffers of dS^T [BKV keys][BQ q rows] bf16
// in the 128-byte swizzle, two buffers of the block's fp32 share of one q
// tile's dQ (in the m64nD accumulator's fragment order: float4 v of thread t
// at v * 128 + t, its 8-column block v at rows r and r + 8), the stages' lse
// and delta, then the barriers.
template <int D>
struct Smem {
  static constexpr int STAGES = ring_stages(D);
  static constexpr int KV = BKV * D * 2;
  static constexpr int QT = BQ * D * 2;
  static constexpr int DS = BKV * BQ * 2;
  static constexpr int ACC = BQ * D * 4;
  static constexpr int V_OFF = KV;
  static constexpr int Q_OFF = 2 * KV;
  static constexpr int DO_OFF = Q_OFF + STAGES * QT;
  static constexpr int DS_OFF = DO_OFF + STAGES * QT;  // [2] buffers
  static constexpr int ACC_OFF = DS_OFF + 2 * DS;      // [2] buffers
  static constexpr int STAT_OFF = ACC_OFF + 2 * ACC;   // [STAGES][2][BQ] fp32
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES + 8) + 1024;  // + alignment slack
};

struct Bars {
  uint64_t* kv_full;      // K and V
  uint64_t* full;         // [ring stages]: Q and dO (TMA) and the stats (32 cp.async arrivals)
  uint64_t* empty;        // [ring stages]
  uint64_t* ds_full;      // [2]: dS^T buffers, both consumers' rows written
  uint64_t* ds_empty;     // [2]: ... and read by the dQ product
  uint64_t* share_full;   // [2]: dQ share buffers, staged by the product's consumer
  uint64_t* share_empty;  // [2]: ... and taken by the writer
};

struct Args {
  const float* lse;
  const float* delta;
  float* dq_acc;  // [B, Hq, n_qt, BQ * D] fp32: the running sums of dQ, fragment order
  int* counters;  // [B, Hq, n_qt]: adds done into each q tile, 0 at the launch
  int hq, Sq, kv_valid, group;
  float scale, scale_log2;
};

// The fixed order in which the key tiles add their shares into a q tile's
// dQ. Under the causal mask key tile t adds into q tiles from 2t (its
// diagonal) on, and the adds go by key tile, as the blocks were launched.
// Without it every key tile that holds a valid key adds into every q tile.
// With `rotate` the block of key tile t sweeps a head's q tiles from
// offset(t) round (the offsets strictly increase, n_kt <= n_qt), and the adds
// into q tile x go by the step at which each block reaches it: first the
// tiles whose offset is at most x, the last of them first, then the others,
// the last of them first. Without `rotate` every sweep starts at q tile 0 and
// the adds go by key tile.
struct DqOrder {
  int n_qt, n_kt;  // q tiles; key tiles that hold a valid key (the adders)
  bool rotate;
  __device__ int offset(int t) const { return rotate ? t * n_qt / n_kt : 0; }
  // key tile t's item i's q tile: the q tile is the outer index and the
  // query head of the group the inner one, so that every block that adds
  // into a q tile of a head reaches it at the same step; causal from the
  // last q tile down to the diagonal, else from the tile's offset round
  template <bool CAUSAL>
  __device__ int q_tile(int t, int group, int i) const {
    const int s = i / group;
    return CAUSAL ? n_qt - 1 - s : (offset(t) + s) % n_qt;
  }
  // -> key tile t's rank among q tile x's adders
  template <bool CAUSAL>
  __device__ int rank(int t, int x) const {
    if (CAUSAL || !rotate) return t;
    const int m = min(n_kt, ((x + 1) * n_kt + n_qt - 1) / n_qt);  // offsets at most x
    return t < m ? m - 1 - t : m + n_kt - 1 - t;
  }
};

// One consumer warpgroup of a block (one block per (BKV-key tile, kv head,
// batch); the producer warpgroup's first warp loads K and V once and runs
// ahead on the ring, copying each q tile's lse and delta with cp.async, zeros
// past Sq, where Q and dO are zero-filled too, so those rows add nothing).
// An item is one query head of the group and one q tile of 64 rows. Per item
// i it runs S^T = K Q^T and dP^T = V dO^T (SS) over its 64 keys, p and ds in
// fp32 registers, writes dS^T to its 64 rows of buffer i % 2, then dV += P^T
// dO and dK += dS^T Q (RS) and, on every other pass, beside them item i - 1's
// dQ share = dS K over the block's 128 keys (SS: dS^T and K MN-major), whose
// dS^T both consumers finished a pass ago, which it stages for the writer.
template <int D, bool CAUSAL>
__device__ __forceinline__ void consumer(unsigned char* smem, const Bars& bar, const Args& a,
                                         int c, int active, int kt, int kvh, int b, int n_items,
                                         const DqOrder& order,
                                         const CUtensorMap* tdk, const CUtensorMap* tdv) {
  using S = Smem<D>;
  using L = Layout<D>;
  constexpr int STAGES = S::STAGES;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, quad = lane & 3;
  const int k0 = kt * BKV, kw0 = k0 + c * WG_ROWS;  // this warpgroup's first key
  const int key0 = kw0 + warp * 16 + lane / 4;      // this thread's keys: key0 and key0 + 8
  unsigned char* ka = smem + c * WG_ROWS * L::ROW;
  unsigned char* va = smem + S::V_OFF + c * WG_ROWS * L::ROW;
  const auto q_tile = [&](int i) { return order.q_tile<CAUSAL>(kt, a.group, i); };

  if (c >= active) {  // keys without a valid one: dS^T rows of zeros, once
    for (int r = tid; r < 2 * WG_ROWS * BQ / 8; r += 128) {
      const int buf = r / (WG_ROWS * BQ / 8), at = r % (WG_ROWS * BQ / 8);
      reinterpret_cast<uint4*>(smem + S::DS_OFF + buf * S::DS + c * WG_ROWS * 128)[at] =
          make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  if (n_items > 0) mbar_wait(bar.kv_full, 0);

  // dQ's share: dS^T of buffer `buf` MN-major (16 keys a k16 step) times K,
  // MN-major, over the block's 128 keys
  const auto issue_dq = [&](float (&dq)[D / 2], int buf) {
    const uint64_t sm = opaque(make_desc_sw128(smem + S::DS_OFF + buf * S::DS, S::DS, 1024));
    const uint64_t km = opaque(L::desc(smem, BKV * L::ROW));
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_ss_d_tt<D>(dq, sm + ((kk * 16 * 128) >> 4), km + mnstep<D>(kk), kk > 0);
  };
  // ... into share buffer j % 2 for the writer, once it is done with item j - 2
  const auto stage = [&](const float (&dq)[D / 2], int j) {
    mbar_wait(bar.share_empty + j % 2, ((j / 2) & 1) ^ 1);
    float4* share = reinterpret_cast<float4*>(smem + S::ACC_OFF + (j % 2) * S::ACC);
#pragma unroll
    for (int v = 0; v < D / 8; ++v)
      share[v * 128 + tid] = make_float4(dq[4 * v], dq[4 * v + 1], dq[4 * v + 2], dq[4 * v + 3]);
    fence_proxy_async();  // before the writer's bulk copy reads it
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.share_full + j % 2);
  };

  // Pass i computes item i's scores, dV and dK and, in the consumer of
  // parity i - 1, item i - 1's dQ share; the last pass only the share.
  for (int i = 0; i <= n_items; ++i) {
    const bool now = i < n_items;
    const int pb = (i + 1) % 2;       // item i - 1's buffers
    const bool own = i > 0 && c == pb;  // this consumer's dQ product
    if (now && c < active) {
      const int st = i % STAGES;
      const unsigned char* sQ = smem + S::Q_OFF + st * S::QT;
      const unsigned char* sdO = smem + S::DO_OFF + st * S::QT;
      const float* lse = reinterpret_cast<const float*>(smem + S::STAT_OFF) + st * 2 * BQ;
      const float* dls = lse + BQ;
      const int q0 = q_tile(i) * BQ;
      mbar_wait(bar.full + st, (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T: D / 16 k16 steps
      float st_[BQ / 2], dpt[BQ / 2];
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
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

      // dS^T into this warpgroup's 64 key rows of buffer i % 2, once item
      // i - 2's product has read it: fragment e of step kk holds keys
      // + 8 (e & 1) at q columns 16 kk + 8 (e >> 1) + 2 quad
      mbar_wait(bar.ds_empty + i % 2, ((i / 2) & 1) ^ 1);
      unsigned char* sds = smem + S::DS_OFF + (i % 2) * S::DS;
      const int krow = c * WG_ROWS + warp * 16 + lane / 4;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = krow + (e & 1) * 8, ch = 2 * kk + (e >> 1);
          *reinterpret_cast<uint32_t*>(sds + row * 128 + ((ch ^ (row & 7)) * 16) + quad * 4) =
              dsf[kk][e];
        }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.ds_full + i % 2);
      if (own) mbar_wait(bar.ds_full + pb, ((i - 1) / 2) & 1);  // both halves written

      // dV += P^T dO and dK += dS^T Q (dO and Q MN-major, N = D), and, in
      // turn, item i - 1's dQ share; each branch waits for its own
      const uint64_t om = opaque(L::desc(sdO, BQ * L::ROW));
      const uint64_t qm = opaque(L::desc(sQ, BQ * L::ROW));
      const auto issue_dkv = [&] {
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_d<D>(dv, pf[kk], om + mnstep<D>(kk));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_d<D>(dk, dsf[kk], qm + mnstep<D>(kk));
      };
      const auto done_dkv = [&] {
        fence_regs(dk);
        fence_regs(dv);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          fence_regs(pf[kk]);
          fence_regs(dsf[kk]);
        }
      };
      if (own) {
        float dq[D / 2];  // scoped here, so that it is not live across passes
        issue_dkv();
        if constexpr (D == 128) {  // dQ's 64 accumulators not beside the fragments
          wgmma_commit();
          wgmma_wait<0>();
          done_dkv();
        }
        issue_dq(dq, pb);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        done_dkv();
        if (lane == 0) mbar_arrive(bar.empty + st);  // one arrival per warp
        if (lane == 0) mbar_arrive(bar.ds_empty + pb);
        stage(dq, i - 1);
      } else {
        issue_dkv();
        wgmma_commit();
        wgmma_wait<0>();
        done_dkv();
        if (lane == 0) mbar_arrive(bar.empty + st);
      }
    } else {
      // no scores of its own (a warpgroup without a valid key, or the last
      // pass): its part in passing the dS^T buffers, and its dQ products
      if (now) {
        mbar_wait(bar.ds_empty + i % 2, ((i / 2) & 1) ^ 1);
        if (lane == 0) mbar_arrive(bar.ds_full + i % 2);
      }
      if (own) {
        float dq[D / 2];
        mbar_wait(bar.ds_full + pb, ((i - 1) / 2) & 1);
        issue_dq(dq, pb);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        if (lane == 0) mbar_arrive(bar.ds_empty + pb);
        stage(dq, i - 1);
      }
    }
  }

  // dK (times scale) and dV in bf16 through this warpgroup's own K and V rows
  // (once the other's dQ products, which read every K row, are done), then
  // TMA stores; rows at or beyond Skv are not written
  named_barrier_sync(3, 256);
  stage_out<D>(ka, BKV, dk, a.scale);
  stage_out<D>(va, BKV, dv, 1.f);
  fence_proxy_async();
  named_barrier_sync(1 + c, 128);
  if (tid == 0) {
#pragma unroll
    for (int jb = 0; jb < L::BOXES; ++jb) {
      tma_store_4d(tdk, ka + jb * BKV * L::ROW, jb * L::COLS, kw0, kvh, b);
      tma_store_4d(tdv, va + jb * BKV * L::ROW, jb * L::COLS, kw0, kvh, b);
    }
    tma_store_commit();
    tma_store_wait_read();
  }
}

// The writer (one thread of the producer's second warp): item j's share, once
// staged, into its q tile's running sum in DqOrder, written by the first
// adder and added by the others, each add after the q tile's counter reads
// its rank.
template <int D, bool CAUSAL>
__device__ __forceinline__ void writer(unsigned char* smem, const Bars& bar, const Args& a,
                                       int kt, int kvh, int b, int n_items,
                                       const DqOrder& order) {
  using S = Smem<D>;
  for (int j = 0; j < n_items; ++j) {
    const int x = order.q_tile<CAUSAL>(kt, a.group, j);
    const int rank = order.rank<CAUSAL>(kt, x);
    const int tile = (b * a.hq + kvh * a.group + j % a.group) * order.n_qt + x;
    const float4* share = reinterpret_cast<const float4*>(smem + S::ACC_OFF + (j % 2) * S::ACC);
    float4* sum = reinterpret_cast<float4*>(a.dq_acc + static_cast<long long>(tile) * (BQ * D));
    mbar_wait(bar.share_full + j % 2, (j / 2) & 1);
    if (rank > 0) wait_counter(a.counters + tile, rank);
    fence_proxy_async_global();
    if (rank == 0)
      bulk_copy_s2g(sum, share, S::ACC);
    else
      bulk_reduce_add_f32(sum, share, S::ACC);
    tma_store_commit();
    // released once it has landed, before any other wait on a counter: a
    // block waits only on adds that precede its own in every q tile's order,
    // so no two blocks wait on each other
    bulk_wait_all();
    fence_proxy_async_global();
    red_release_gpu_inc(a.counters + tile);
    mbar_arrive(bar.share_empty + j % 2);
  }
}

// dq from the running sums, once every key tile has added into them: one
// block a q tile reads its fp32 sums (fragment order, see Smem) into shared
// memory and writes rows of scale * dQ in bf16, 16 bytes a thread.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert_kernel(const float* dq_acc, bf16* dq, Strides dqs, int hq, int Sq,
                            float scale) {
  // block v of the 128 threads at v * 129: the 16-byte reads of one row's
  // neighbouring blocks fall in different banks
  __shared__ float4 tile_s[BQ * D / 4 + D / 8];
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int tile = blockIdx.x, x = tile % n_qt, h = (tile / n_qt) % hq, b = tile / n_qt / hq;
  const float4* sum =
      reinterpret_cast<const float4*>(dq_acc + static_cast<long long>(tile) * BQ * D);
  for (int f = threadIdx.x; f < BQ * D / 4; f += 256) tile_s[f + f / 128] = __ldcs(sum + f);
  __syncthreads();
  bf16* rows = dq + b * dqs.batch + h * dqs.head;
  for (int k = threadIdx.x; k < BQ * D / 8; k += 256) {
    // row r's 8 columns from 8 cb: threads 32 (r / 16) + 4 (r % 8) + q of
    // the product's warpgroup, q = 0..3, at half r % 16 / 8 of their float4
    const int r = k / (D / 8), cb = k % (D / 8);
    const int t = (r / 16) * 32 + (r % 8) * 4, hi = (r % 16) / 8;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = tile_s[cb * 129 + t + q];
      w[q] = hi ? pack_bf16(v.z * scale, v.w * scale) : pack_bf16(v.x * scale, v.y * scale);
    }
    if (x * BQ + r < Sq)
      *reinterpret_cast<uint4*>(rows + (x * BQ + r) * dqs.row + cb * 8) =
          make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                 const Args a) {
  using S = Smem<D>;
  using L = Layout<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Bars bar;
  bar.kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  bar.full = bar.kv_full + 1;
  bar.empty = bar.full + STAGES;
  bar.ds_full = bar.empty + STAGES;
  bar.ds_empty = bar.ds_full + 2;
  bar.share_full = bar.ds_empty + 2;
  bar.share_empty = bar.share_full + 2;

  const GridPos pos = grid_pos(CAUSAL);
  const int kt = pos.tile;  // causal: tile 0 is the heaviest
  const int k0 = kt * BKV;
  const int kvh = pos.head, b = pos.batch;
  // consumer warpgroups that hold a valid key (warpgroup 0 whenever any
  // does); a block with none loads nothing, adds nothing and stores zeros
  const int active = max(0, min(CONSUMERS, (a.kv_valid - k0 + WG_ROWS - 1) / WG_ROWS));
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int n_kt = (a.kv_valid + BKV - 1) / BKV;
  const DqOrder order{n_qt, n_kt, !CAUSAL && n_kt <= min(n_qt, ROTATE_MAX_TILES)};
  const int n_q = n_qt - (CAUSAL ? k0 / BQ : 0);  // q tiles of each head
  const int n_items = active > 0 ? a.group * n_q : 0;  // (q tile, query head) pairs
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar.full + s, 1 + 32);  // the TMA thread's arrival and 32 cp.async ones
      mbar_init(bar.empty + s, 4 * max(active, 1));  // one arrival per active consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar.ds_full + s, 4 * CONSUMERS);  // one arrival per consumer warp
      mbar_init(bar.ds_empty + s, 4);             // ... of the one that reads it
      mbar_init(bar.share_full + s, 4);
      mbar_init(bar.share_empty + s, 1);  // the writer's
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x / 32;
    if (warp == 1 && lane == 0) writer<D, CAUSAL>(smem, bar, a, kt, kvh, b, n_items, order);
    if (warp != 0 || n_items == 0) return;
    // item j into stage j % STAGES, once it is free: the Q and dO tiles of
    // its query head and q tile, and their rows' lse and delta
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
    for (int j = 0; j < n_items; ++j) {
      const int st = j % STAGES;
      const int h = kvh * a.group + j % a.group, q0 = order.q_tile<CAUSAL>(kt, a.group, j) * BQ;
      mbar_wait(bar.empty + st, ((j / STAGES) & 1) ^ 1);
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
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consumer<D, CAUSAL>(smem, bar, a, wg - 1, active, kt, kvh, b, n_items, order, &tdk, &tdv);
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


// everything an entry takes
struct Tensors {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float* dq_acc;
  int* counters;
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

// the delta launch, then the backward
template <int D>
cudaError_t launch_bwd(const Tensors& t, int B, int hq, int hkv, int Sq, int Skv, int kv_valid,
                       int causal, float scale, cudaStream_t stream) {
  using S = Smem<D>;
  CUtensorMap mq, mdo, mk, mv, mdk, mdv;
  // a view TMA cannot describe (strides off 16 bytes, a base off 16 bytes)
  if (!make_map<D>(&mq, t.q, Sq, hq, B, t.qs, BQ) ||
      !make_map<D>(&mdo, t.dout, Sq, hq, B, t.dos, BQ) ||
      !make_map<D>(&mk, t.k, kv_valid, hkv, B, t.ks, BKV) ||
      !make_map<D>(&mv, t.v, kv_valid, hkv, B, t.vs, BKV) ||
      !make_map<D>(&mdk, t.dk, Skv, hkv, B, t.dks, WG_ROWS) ||
      !make_map<D>(&mdv, t.dv, Skv, hkv, B, t.dvs, WG_ROWS))
    return cudaErrorInvalidPitchValue;
  const long long rows = static_cast<long long>(B) * hq * Sq;
  const long long n_qt = (Sq + BQ - 1) / BQ;
  const long long blocks = (rows * 16 + 255) / 256;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const bf16*>(t.out), t.os, static_cast<const bf16*>(t.dout), t.dos, t.delta,
      hq, Sq, rows, t.counters, static_cast<long long>(B) * hq * n_qt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Args a{t.lse, t.delta, t.dq_acc, t.counters, hq, Sq, kv_valid, hq / hkv, scale,
               scale * LOG2E};
  const dim3 grid = make_grid(causal, (Skv + BKV - 1) / BKV, hkv, B);
  err = causal ? launch(flash_bwd_kernel<D, true>, S::BYTES, grid, BLOCK_THREADS, stream, mq, mdo,
                        mk, mv, mdk, mdv, a)
               : launch(flash_bwd_kernel<D, false>, S::BYTES, grid, BLOCK_THREADS, stream, mq,
                        mdo, mk, mv, mdk, mdv, a);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(B) * hq * n_qt;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_bwd_dq_convert_kernel<D><<<static_cast<unsigned>(tiles), 256, 0, stream>>>(
      t.dq_acc, static_cast<bf16*>(t.dq), t.dqs, hq, Sq, scale);
  return cudaGetLastError();
}

// Checks what the kernels rely on and picks the instantiation.
int dispatch(const Tensors& t, int B, int hq, int hkv, int Sq, int Skv, int D, int kv_valid,
             int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || hkv <= 0 || hq % hkv != 0 || kv_valid <= 0 ||
      kv_valid > Skv || (causal && Sq != Skv) || (D != 64 && D != 96 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  // the grid is (key tiles, kv heads, batch) or (kv heads, batch, key tiles)
  if (B > 65535 || hkv > 65535 || (Skv + BKV - 1) / BKV > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D == 64   ? launch_bwd<64>(t, B, hq, hkv, Sq, Skv, kv_valid, causal, scale, st)
      : D == 96 ? launch_bwd<96>(t, B, hq, hkv, Sq, Skv, kv_valid, causal, scale, st)
                : launch_bwd<128>(t, B, hq, hkv, Sq, Skv, kv_valid, causal, scale, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Both return 0 on success, else the cudaError_t of the failed launch
// (cudaErrorInvalidPitchValue: a view TMA cannot describe). Shapes, dtypes,
// strides and alignment are checked by the Python wrappers. Strides are in
// elements, for (batch, head, row). Each reads q, k, v, out, dout and lse,
// writes delta [B, Hq, Sq] fp32, dq, dk and dv, and uses dq_acc (fp32, B * Hq
// * ceil(Sq / 64) * 64 * D floats, any contents) and counters (int32, B * Hq
// * ceil(Sq / 64), any contents) as its workspace: three launches, the first of
// which sets the counters to 0.

// The fused array: strides[0..2] qkv's, [3..5] out's, [6..8] dout's, [9..11]
// dqkv's; dq, dk and dv are heads [0, Hq), [Hq, Hq + Hkv) and
// [Hq + Hkv, Hq + 2*Hkv) of dqkv.
int aigv_flash_attn_qkv_bwd(const void* qkv, const void* out, const void* dout, const void* lse,
                            void* delta, void* dqkv, void* dq_acc, void* counters, int B, int hq,
                            int hkv, int S, int D, int kv_valid, int causal,
                            const long long* s, float scale, void* stream) {
  const auto* q = static_cast<const bf16*>(qkv);
  auto* g = static_cast<bf16*>(dqkv);
  const Strides in{s[0], s[1], s[2]}, grad{s[9], s[10], s[11]};
  const Tensors t{q,
                  q + hq * in.head,
                  q + (hq + hkv) * in.head,
                  out,
                  dout,
                  static_cast<const float*>(lse),
                  static_cast<float*>(delta),
                  g,
                  g + hq * grad.head,
                  g + (hq + hkv) * grad.head,
                  static_cast<float*>(dq_acc),
                  static_cast<int*>(counters),
                  in,
                  in,
                  in,
                  Strides{s[3], s[4], s[5]},
                  Strides{s[6], s[7], s[8]},
                  grad,
                  grad,
                  grad};
  return dispatch(t, B, hq, hkv, S, S, D, kv_valid, causal, scale, stream);
}

// Three tensors: strides[0..2] q's, [3..5] k's, [6..8] v's, [9..11] out's,
// [12..14] dout's, [15..17] dq's, [18..20] dk's, [21..23] dv's.
int aigv_flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, void* dq_acc, void* counters, int B, int hq, int hkv, int Sq,
                        int Skv, int D, int kv_valid, int causal, const long long* s,
                        float scale, void* stream) {
  const Tensors t{q, k, v, out, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, static_cast<float*>(dq_acc),
                  static_cast<int*>(counters), Strides{s[0], s[1], s[2]},
                  Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
                  Strides{s[9], s[10], s[11]}, Strides{s[12], s[13], s[14]},
                  Strides{s[15], s[16], s[17]}, Strides{s[18], s[19], s[20]},
                  Strides{s[21], s[22], s[23]}};
  return dispatch(t, B, hq, hkv, Sq, Skv, D, kv_valid, causal, scale, stream);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
