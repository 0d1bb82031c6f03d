// The decode matvec shared by the fp8 matmul (fp8_matmul.cu, K9) and the GEMV
// form of the weight-only matmuls (weight_only_matmul.cu, K6 / K7): a few bf16
// rows of activations against a weight of one value per byte (fp8, int8) or
// two (packed int4), converted in registers, never into device memory.
//
//   y[M, N] = bf16( (x[M, K] @ convert(w)[N, K]^T) * scale[N] (+ bias[N]) )
//
//   x      bf16 [M, K], row stride ldx elements.
//   w      one row of ceil(K / KPB) bytes per output channel, row stride ldw
//          bytes, the K values of a channel in order (int4: low nibble first).
//   scale  fp32 [N], applied to the fp32 sum; bias bf16 [N] or null, added in
//          fp32; the result is rounded to bf16 once.
//   M, N and K are any size: edges are predicated and zero-filled here, not
//   padded by the caller.
//
// What bounds it. At decode (M <= 8) each weight byte is used M times: the
// weight bytes are nearly all the traffic, and the time is bounded by reading
// them once from device memory. Everything else serves that stream.
//
// Two bodies compute it. Both are matvecs with the operands swapped: y^T [N,
// M] = w [N, K] . x^T [K, M], so one mma.sync m16n8k16 takes 16 output
// channels as its rows (A, the converted weight) and 8 rows of x as its
// columns (B): the decode rows fill the mma's n = 8, and no 128-row tile is
// wasted on M = 1..8. The mma's K order inside a step is free as long as A
// and B agree: each 4-byte word of the weight converts to 2 * KPB bf16 pairs
// of consecutive K (`Fmt::convert`), and pairs 2i and 2i + 1 of both
// channels, with x's pairs at the same K, are the operands of the word's mma
// i, with no shuffle.
//
// The tile body (`decode_matvec_kernel`, `launch_tiles`; the GEMV form of K6
// / K7, and K9 where the stream body does not apply): a block owns 16
// channels and 8 rows of x and its 8 warps split K: warp w takes the
// 64-byte weight steps w, w + 8, ... , four of them in flight at a time. In a
// step, lane 4g + t reads 16 contiguous weight bytes of channels g and g + 8
// at byte offset 16t (one 16-byte load each, not kept in L1) and the 16 * KPB
// values of x row g that those bytes hold (2 * KPB 16-byte loads), so every
// operand comes straight from the registers the loads filled. The eight
// warps' accumulators are summed through shared memory, and warp 0 applies
// the scale and the bias and stores.
//
// For M > 8 the tile grid's second dimension walks blocks of 8 rows of x, each
// reading the weight again. Loads are 16 bytes wide when the pointer and the
// row stride allow it (w: ldw a multiple of 16 bytes; x: ldx a multiple of 8
// elements) and the 16 values lie below the row's end; otherwise that span is
// gathered element by element, which is slow and meant for odd shapes and
// the last span of an odd K.
//
// The stream body (`stream_kernel`, `launch_stream`; below, with its own
// account): a persistent grid of streams of 8 or 16 warps, each warp copying
// its steps into a ring in shared memory ahead of its products across work
// items, the warps' sums merged one item late. It needs rows that start on
// 16 bytes.
//
// A format is a struct with
//   static constexpr int KPB;  // weight values per byte: 1 or 2
//   static __device__ void convert(uint32_t word, uint32_t (&pairs)[2 * KPB]);
// where `convert` turns four weight bytes into 2 * KPB registers of two bf16
// each, the values in K order, lower K in the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_fragments.cuh"

namespace decode_matvec {

constexpr int ROWS = 8;     // rows of x per block: the mma's n
constexpr int CH = 16;      // output channels per block: the mma's m
constexpr int KSTEP = 64;   // weight bytes per warp step: 4 lanes x 16 bytes
constexpr int WARPS = 8;
constexpr int NTHREADS = 32 * WARPS;
constexpr int UNROLL = 4;   // steps in flight per warp

// 16 weight bytes of a channel row from byte kb; zero beyond the row's
// `valid` bytes or for a channel that does not exist. The vector load
// bypasses L1: each weight byte is read once.
__device__ __forceinline__ uint4 load_w(const unsigned char* __restrict__ row, long long kb,
                                        long long valid, bool ok, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!ok || kb >= valid) return v;
  if (vec && kb + 16 <= valid) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(row + kb));
    return v;
  }
  uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (kb + i < valid) b[i / 4] |= static_cast<uint32_t>(row[kb + i]) << (8 * (i % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// 16 * SPANS bf16 of a row of x from element kk, as 8 * SPANS bf16 pairs;
// zero beyond K or for a row that does not exist
template <int SPANS>
__device__ __forceinline__ void load_x(uint32_t (&v)[8 * SPANS],
                                       const __nv_bfloat16* __restrict__ row, long long kk, int K,
                                       bool ok, bool vec) {
#pragma unroll
  for (int i = 0; i < 8 * SPANS; ++i) v[i] = 0;
  if (!ok) return;
#pragma unroll
  for (int s = 0; s < SPANS; ++s) {
    const long long k0 = kk + 16 * s;
    if (k0 >= K) return;
    if (vec && k0 + 16 <= K) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + k0));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + k0 + 8));
      v[8 * s + 0] = a.x, v[8 * s + 1] = a.y, v[8 * s + 2] = a.z, v[8 * s + 3] = a.w;
      v[8 * s + 4] = b.x, v[8 * s + 5] = b.y, v[8 * s + 6] = b.z, v[8 * s + 7] = b.w;
      continue;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k0 + i < K)
        v[8 * s + i / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(row[k0 + i]))
                            << (16 * (i % 2));
  }
}

template <class Fmt>
__global__ void __launch_bounds__(NTHREADS)
    decode_matvec_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w,
                         const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, int M, int N, int K, long long ldx,
                         long long ldw, long long ldy, bool vec_x, bool vec_w) {
  constexpr int KPB = Fmt::KPB;
  __shared__ float4 partial[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * CH, m0 = blockIdx.y * ROWS;
  const bool lo_ok = n0 + g < N, hi_ok = n0 + g + 8 < N, x_ok = m0 + g < M;
  const unsigned char* w_lo = w + static_cast<long long>(n0 + g) * ldw;
  const unsigned char* w_hi = w_lo + 8 * ldw;
  const __nv_bfloat16* xr = x + static_cast<long long>(m0 + g) * ldx;
  const long long w_valid = (static_cast<long long>(K) + KPB - 1) / KPB;  // bytes of a row

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // (channel g, rows 2t, 2t+1), (channel g + 8, ...)
  const int steps = static_cast<int>((w_valid + KSTEP - 1) / KSTEP);
  for (int s0 = warp; s0 < steps; s0 += WARPS * UNROLL) {
    uint4 wl[UNROLL], wh[UNROLL];
    uint32_t xv[UNROLL][8 * KPB];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * WARPS;
      const long long kb = static_cast<long long>(s) * KSTEP + 16 * t;
      const bool in = s < steps;
      wl[u] = load_w(w_lo, kb, w_valid, lo_ok && in, vec_w);
      wh[u] = load_w(w_hi, kb, w_valid, hi_ok && in, vec_w);
      load_x<KPB>(xv[u], xr, kb * KPB, K, x_ok && in, vec_x);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t lo[4] = {wl[u].x, wl[u].y, wl[u].z, wl[u].w};
      const uint32_t hi[4] = {wh[u].x, wh[u].y, wh[u].z, wh[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // K of the word: 4 KPB j .. 4 KPB j + 4 KPB - 1
        uint32_t pl[2 * KPB], ph[2 * KPB];
        Fmt::convert(lo[j], pl);
        Fmt::convert(hi[j], ph);
#pragma unroll
        for (int i = 0; i < KPB; ++i) {
          const uint32_t a[4] = {pl[2 * i], ph[2 * i], pl[2 * i + 1], ph[2 * i + 1]};
          mma_16816(acc, a, xv[u][2 * KPB * j + 2 * i], xv[u][2 * KPB * j + 2 * i + 1]);
        }
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
    if (n < N && m < M) {
      const float b = bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
      y[m * ldy + n] = __float2bfloat16_rn(sum[i] * scale[n] + b);
    }
  }
}

// Checks the arguments, picks the load widths and launches the tile body;
// returns the cudaError_t of the launch (0 on success).
template <class Fmt>
int launch_tiles(const void* x, const void* w, const void* scale, const void* bias, void* y,
                 int M, int N, int K, long long ldx, long long ldw, long long ldy, void* stream) {
  const long long w_valid = (static_cast<long long>(K) + Fmt::KPB - 1) / Fmt::KPB;
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < w_valid || ldy < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + CH - 1) / CH, (M + ROWS - 1) / ROWS);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0;
  decode_matvec_kernel<Fmt><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, ldx, ldw, ldy, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------ the persistent split-K stream --
//
// The same function and operands as the tile body, streamed so that bytes
// stay in flight across steps and work items, with no block waiting for
// another. K9 takes it (ops/fp8_matmul.fp8_form) where the rows of x and of
// the weight start on 16 bytes and the plan gives it something to overlap.
//
// Work. An item is 16 output channels (a tile) x 8 rows of x: the mma's
// shape. A block of 16 warps, one a SM, runs 16 / split streams side by side;
// the `split` warps of a stream split the K of each item (warp w of the
// stream takes the 64-byte weight steps w, w + split, ...) and walk a
// contiguous run of items (`plan`). The split is 8, or 16 where that leaves
// the busiest warp fewer steps (w2's 128 tiles: K is split twice as finely
// inside the block, and the split sums merge in its shared memory). The grid
// is persistent: at most one block a SM.
//
// Stream. A warp's steps over all its items form one sequence, copied with
// cp.async into a ring of DEPTH slots of its own in shared memory, DEPTH - 1
// steps ahead of its products, also across the end of an item, so a warp
// keeps DEPTH - 1 steps in flight while it computes, merges and stores. A
// lane reads back only the bytes it copied: no barrier between warps. A
// copy's zero fill covers the rows' ends and rows that do not exist.
//
// Merge, deterministic and inside the launch. At the end of an item each
// warp of a stream writes its accumulators into one of two buffers in shared
// memory and arrives at the buffer's `full` mbarrier; the stream's first 128
// threads wait on it only at the end of the next item, then each sums one of
// the 128 outputs over the split warps, in warp order, applies the scale and
// the bias (loaded an item ahead) and stores, and arrives at `empty`, which a
// warp waits on before it writes that buffer again. No workspace, no
// counter, no atomics, no cluster: two launches give the same bits, and a
// graph replay gives an eager launch's.
//
// What was tried on an H100 (`PERF.md`): K split across the blocks of a
// thread-block cluster, merged through distributed shared memory (its launch
// with no weight took 4.8 us against 2.2, every cluster barrier fenced the
// block and emptied its L1); a register ring unrolled by its depth (its code,
// 100 KB, cost ~1 us a launch in instruction fetch); rings of 3 to 6 slots
// (4 best); 128-byte steps; x copied once a warp for all its items (no gain:
// x stays in L1); rows off 16 bytes by 4- and 8-byte copies (slower than the
// tile body's gathers); a bit-placement e4m3 convert (slower).

constexpr int STREAM_WARPS = 16;  // warps of a block, one block a SM
constexpr int STREAM_THREADS = 32 * STREAM_WARPS;

// A launch's work: `split` warps a stream (8 or 16), `streams` streams, the
// first `extra` of them taking per + 1 items and the rest `per`; blocks =
// ceil(streams * split / 16).
struct Plan {
  int split, streams, per, extra, blocks;
};

// The plan of a launch at (M, N, K) with `kpb` weight values a byte on `sms`
// SMs (ops/fp8_matmul.matvec_plan mirrors it): for each split, as many
// streams as the card holds at once, at most one an item; of the two, the
// split whose busiest warp streams fewer steps, 8 on a tie.
inline Plan plan(int M, int N, int K, int kpb, int sms) {
  const long long items = static_cast<long long>((N + CH - 1) / CH) * ((M + ROWS - 1) / ROWS);
  const long long steps = ((static_cast<long long>(K) + kpb - 1) / kpb + KSTEP - 1) / KSTEP;
  Plan best = {0, 0, 0, 0, 0};
  long long best_steps = 0;
  for (int split = WARPS; split <= STREAM_WARPS; split *= 2) {
    const long long slots = static_cast<long long>(sms) * (STREAM_WARPS / split);
    const long long streams = items < slots ? items : slots;
    const long long busiest = (items + streams - 1) / streams * ((steps + split - 1) / split);
    if (best.split == 0 || busiest < best_steps) {
      const int per_block = STREAM_WARPS / split;
      best = {split, static_cast<int>(streams), static_cast<int>(items / streams),
              static_cast<int>(items % streams),
              static_cast<int>((streams + per_block - 1) / per_block)};
      best_steps = busiest;
    }
  }
  return best;
}

// the SM count of the current device, read once per device; 0 on an error
inline int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0 &&
      cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return cache[dev];
}

struct StreamArgs {
  const __nv_bfloat16* x;
  const unsigned char* w;
  const float* scale;
  const __nv_bfloat16* bias;
  __nv_bfloat16* y;
  int M, N, K;
  Plan plan;
  long long ldx, ldw, ldy;
};

// where a lane's loads of an item come from
struct Source {
  const unsigned char *lo, *hi;  // weight rows of channels g and g + 8
  const __nv_bfloat16* x;        // row g of the item's 8 rows of x
  bool lo_ok, hi_ok, x_ok;
};

// 16 bytes from global to shared memory without blocking the thread: the
// first `valid` (0..16) of src, zeros after them; nothing is read for 0. The
// weight's copies (STREAM) skip L1 and ask L2 to fetch the 256 bytes around
// them (1% off w13's time on an H100); x's stay in L1 for the next item.
template <bool STREAM>
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int valid) {
  if (STREAM)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 ::"r"(hopper::smem_u32(dst)), "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
                 "l"(src), "r"(valid)
                 : "memory");
}

// The ring's geometry for a format: a slot holds one step of a warp, chunk
// c (16 bytes a lane) at c * 512 + 16 * lane: the weight rows g and g + 8,
// then x's 16 * KPB values of row g as 2 * KPB chunks.
template <int KPB>
struct Ring {
  static constexpr int DEPTH = 4;  // slots of a warp: DEPTH - 1 steps in flight
  static constexpr int CHUNKS = 2 + 2 * KPB;
  static constexpr int SLOT = CHUNKS * 512;
  static constexpr int BYTES = STREAM_WARPS * DEPTH * SLOT;
};

template <class Fmt>
__global__ void __launch_bounds__(STREAM_THREADS, 1) stream_kernel(const StreamArgs a) {
  constexpr int KPB = Fmt::KPB;
  using R = Ring<KPB>;
  constexpr int DEPTH = R::DEPTH;
  constexpr int OUT = CH * ROWS;  // outputs of an item; one a merging thread
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float4 partial[2][STREAM_WARPS][32];
  // per stream and buffer: all of the stream's threads have written their
  // partials (full), the merging threads have read them (empty)
  __shared__ uint64_t full[2][2], empty[2][2];
  const int lg = a.plan.split == 16 ? 4 : 3, split = 1 << lg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sub = warp >> lg, wg = warp & (split - 1);  // the stream in the block, the warp in it
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) {
      hopper::mbar_init(&full[i / 2][i % 2], 32 * split);
      hopper::mbar_init(&empty[i / 2][i % 2], OUT);
    }
  }
  __syncthreads();
  const int stream = (blockIdx.x << (4 - lg)) + sub;
  if (stream >= a.plan.streams) return;  // the idle half of the last block
  const int n_items = a.plan.per + (stream < a.plan.extra ? 1 : 0);
  const int i0 = stream * a.plan.per + min(stream, a.plan.extra);
  const int rblocks = (a.M + ROWS - 1) / ROWS;
  const long long w_valid = (static_cast<long long>(a.K) + KPB - 1) / KPB;  // bytes of a row
  const int steps = static_cast<int>((w_valid + KSTEP - 1) / KSTEP);
  const int nw = steps > wg ? ((steps - wg - 1) >> lg) + 1 : 0;
  const int total = n_items * nw;  // this warp's steps over all its items
  const long long kb0 = static_cast<long long>(wg) * KSTEP + 16 * t;
  const long long kstride = static_cast<long long>(split) * KSTEP;
  const int tile0 = i0 / rblocks, rb0 = i0 - tile0 * rblocks;
  unsigned char* my_ring = ring + warp * DEPTH * R::SLOT + 16 * lane;

  // an item's place: its tile and row block, advanced without a division
  struct Cursor {
    int tile, rb;
  };
  auto next = [&](Cursor& c) {
    if (++c.rb == rblocks) c.rb = 0, ++c.tile;
  };
  auto source = [&](const Cursor& c) {
    const int m = c.rb * ROWS + g, n = c.tile * CH + g;
    Source src;
    src.lo = a.w + static_cast<long long>(n) * a.ldw;
    src.hi = src.lo + 8 * a.ldw;
    src.x = a.x + static_cast<long long>(m) * a.ldx;
    src.lo_ok = n < a.N, src.hi_ok = n + 8 < a.N, src.x_ok = m < a.M;
    return src;
  };

  // The load cursor (item, step of the item) copies its step into a slot
  // and moves on; every call commits one cp.async group, empty past the end.
  Cursor l_at = {tile0, rb0};
  Source src = source(l_at);
  int l_item = 0, l_j = 0;
  long long kb = kb0;
  // 16 bytes a lane at dst; the copy's zero fill covers the rows' ends and
  // what does not exist
  auto fetch = [&](unsigned char* dst, const void* from, long long left, bool ok, bool weight) {
    const int valid = !ok || left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
    if (weight)
      cp_async_16<true>(dst, from, valid);
    else
      cp_async_16<false>(dst, from, valid);
  };
  // x's values for weight bytes kw .. kw + 15 of the row g of src's x, as
  // 2 * KPB chunks at dst, dst + 512, ...
  auto fetch_x = [&](unsigned char* dst, long long kw) {
#pragma unroll
    for (int c = 0; c < 2 * KPB; ++c) {
      const long long k0 = kw * KPB + 8 * c;
      fetch(dst + c * 512, src.x + k0, 2 * (a.K - k0), src.x_ok, false);
    }
  };
  auto issue = [&](int slot, bool live) {
    unsigned char* dst = my_ring + slot * R::SLOT;
    if (live) {
      fetch(dst, src.lo + kb, w_valid - kb, src.lo_ok, true);
      fetch(dst + 512, src.hi + kb, w_valid - kb, src.hi_ok, true);
      fetch_x(dst + 1024, kb);
      kb += kstride;
      if (++l_j == nw) {
        l_j = 0;
        kb = kb0;
        next(l_at);
        if (++l_item < n_items) src = source(l_at);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // (channel g, rows 2t, 2t+1), (channel g + 8, ...)
  auto compute = [&](int slot) {
    const unsigned char* at = my_ring + slot * R::SLOT;
    const uint4 wlo = *reinterpret_cast<const uint4*>(at);
    const uint4 whi = *reinterpret_cast<const uint4*>(at + 512);
    uint32_t xs[8 * KPB];
#pragma unroll
    for (int c = 0; c < 2 * KPB; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(at + (2 + c) * 512);
      xs[4 * c] = v.x, xs[4 * c + 1] = v.y, xs[4 * c + 2] = v.z, xs[4 * c + 3] = v.w;
    }
    const uint32_t lo[4] = {wlo.x, wlo.y, wlo.z, wlo.w};
    const uint32_t hi[4] = {whi.x, whi.y, whi.z, whi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // K of the word: 4 KPB j .. 4 KPB j + 4 KPB - 1
      uint32_t pl[2 * KPB], ph[2 * KPB];
      Fmt::convert(lo[j], pl);
      Fmt::convert(hi[j], ph);
#pragma unroll
      for (int i = 0; i < KPB; ++i) {
        const uint32_t f[4] = {pl[2 * i], ph[2 * i], pl[2 * i + 1], ph[2 * i + 1]};
        mma_16816(acc, f, xs[2 * KPB * j + 2 * i], xs[2 * KPB * j + 2 * i + 1]);
      }
    }
  };

  // The merge. Thread o < 128 of the stream owns output o of every item:
  // float o of a warp's 32 float4, channel g + 8 (e >= 2), row 2 t + (e & 1)
  // of the lane o / 4. Its scale and bias are loaded one item ahead.
  const int o = wg * 32 + lane, ln = o >> 2, e = o & 3;
  const bool merger = o < OUT;
  Cursor c_at = {tile0, rb0};
  long long r_at = 0;
  bool r_live = false;
  float r_scale = 0.f, r_bias = 0.f;
  auto prefetch = [&]() {  // the output of item c_at
    const int n = c_at.tile * CH + (ln >> 2) + (e >= 2 ? 8 : 0);
    const int m = c_at.rb * ROWS + 2 * (ln & 3) + (e & 1);
    r_live = n < a.N && m < a.M;
    r_at = static_cast<long long>(m) * a.ldy + n;
    r_scale = r_live ? a.scale[n] : 0.f;
    r_bias = r_live && a.bias != nullptr ? __bfloat162float(a.bias[n]) : 0.f;
  };
  auto merge = [&](int li) {  // item li, whose output prefetch() has read
    hopper::mbar_wait(&full[sub][li & 1], (li >> 1) & 1);
    const float* p = reinterpret_cast<const float*>(&partial[li & 1][sub * split][0]) + o;
    float sum = 0.f;
    for (int w = 0; w < split; ++w) sum += p[w * 128];
    hopper::mbar_arrive(&empty[sub][li & 1]);
    if (r_live) a.y[r_at] = __float2bfloat16_rn(sum * r_scale + r_bias);
  };
  if (merger) prefetch();

  int c_item = 0;  // the compute cursor's item
  auto finish = [&]() {
    const int b = c_item & 1;
    if (c_item >= 2) hopper::mbar_wait(&empty[sub][b], ((c_item - 2) >> 1) & 1);
    partial[b][warp][lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
    hopper::mbar_arrive(&full[sub][b]);
    if (merger && c_item >= 1) {  // the item before this one, a whole item later
      merge(c_item - 1);
      prefetch();
    }
    next(c_at);
    ++c_item;
  };

  for (int u = 0; u < DEPTH - 1; ++u) issue(u, u < total);
  int c_j = 0, slot = 0;
  for (int f = 0; f < total; ++f) {
    issue(slot == 0 ? DEPTH - 1 : slot - 1, f + DEPTH - 1 < total);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DEPTH - 1) : "memory");  // step f has landed
    compute(slot);
    slot = slot == DEPTH - 1 ? 0 : slot + 1;
    if (++c_j == nw) {
      c_j = 0;
      finish();
    }
  }
  if (nw == 0)
    for (int i = 0; i < n_items; ++i) finish();
  if (merger) merge(n_items - 1);  // its output read by the last finish(), or before the loop
}

// Checks the arguments, picks the plan and launches the stream body: x and
// the weight with 16-byte aligned bases and row strides (else
// cudaErrorInvalidPitchValue: the copies need them). Returns the cudaError_t
// of the launch (0 on success).
template <class Fmt>
int launch_stream(const void* x, const void* w, const void* scale, const void* bias, void* y,
                  int M, int N, int K, long long ldx, long long ldw, long long ldy,
                  void* stream) {
  const long long w_valid = (static_cast<long long>(K) + Fmt::KPB - 1) / Fmt::KPB;
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < w_valid || ldy < N ||
      static_cast<long long>((N + CH - 1) / CH) * ((M + ROWS - 1) / ROWS) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || ldx % 8 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || ldw % 16 != 0)
    return static_cast<int>(cudaErrorInvalidPitchValue);
  const Plan p = plan(M, N, K, Fmt::KPB, sms);
  const StreamArgs a = {static_cast<const __nv_bfloat16*>(x),
                        static_cast<const unsigned char*>(w),
                        static_cast<const float*>(scale),
                        static_cast<const __nv_bfloat16*>(bias),
                        static_cast<__nv_bfloat16*>(y), M, N, K, p, ldx, ldw, ldy};
  constexpr int smem = Ring<Fmt::KPB>::BYTES;
  // set once per device: the host cost of a decode step counts
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(stream_kernel<Fmt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  stream_kernel<Fmt><<<p.blocks, STREAM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_matvec
