// Single-token decode attention for sm_90a: one query token per sample
// against the read-only KV cache, over each sample's own window of rows,
// optionally with the current token merged in. One launch either way.
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// aigv_assessor_tpu/ops/decode_attention.py (through `decode_attention`) and,
// with the merge, the whole of its `cached_decode_attention`: the kernel
// followed by `merge_new_token`.
//
//   q       bf16 [B, Hq, D]           strides (q_sb, q_sh, 1)
//   k, v    bf16 [B, max_len, Hkv, D] strides (sb, sr, sh, 1): the model's
//           cache layout, read in place
//   starts  int32 [B], end int32 [1], both in device memory: sample b attends
//           rows [starts[b], end) and the kernel loads no other row
//   k_new, v_new  bf16 [B, Hkv, D] strides (sb, sh, 1), or null: the current
//           token, which is not in the cache
//   out     bf16 [B, Hq, D], contiguous
//   m, l    fp32 [B, Hq], only without the current token
//   Query heads h*G .. (h+1)*G-1 share kv head h (G = Hq / Hkv <= 16). D is
//   64, 96 (Phi-3-mini) or 128: the body is written in D / 8 and D / 16, and
//   a padded row of D + 8 values stays a whole number of 16-byte vectors
//   (208 bytes at D = 96) for cp.async and ldmatrix.
//
// Without k_new: out = softmax(q k^T * scale) v over the window, or 0 for an
// empty window, with m the window's largest scaled score (-1e30 for an empty
// window) and l the sum of exp(score - m), for a caller that merges the
// current token itself. With k_new: out = the softmax over the window plus
// the current token, applied to the window's v rows plus v_new; an empty
// window gives v_new exactly.
//
// What bounds it. Every K and V row of the window is read once and used for
// G dot products of D terms: 2*G operations per byte at most, so the bytes
// bound it, (end - start_b) * Hkv * D * 2 * 2 per sample. So the card's
// memory must stay busy from the first tile to the last, nothing outside the
// window is read, and no second launch is spent. On an H100 a launch's
// fixed cost (about 4.5 us: the launch, reading starts and end, the first
// tile's latency, the merge and the stores) is the rest.
//
// Design. The TPU kernel walks a (B, max_len / BLK) grid in sequence with a
// running state in scratch memory; here nothing carries over between blocks,
// so the window is cut, and the pieces are merged inside the launch. The
// launch takes one of two forms, picked by the wrapper from B, Hkv, the
// capacity and the card's SM count, the only sizes the host knows:
//
// - The split form. The grid is (Hkv, nsplit, B): a block of 4 warps takes
//   the G query heads of one kv head and one contiguous 1/nsplit of its
//   sample's window, computed in the kernel from starts[b] and end; two
//   blocks share an SM (about 70 KB of shared memory each), and the grid
//   fills 7/8 of those slots, so that the clusters below find room in one
//   wave. A block whose piece is empty loads nothing and goes straight to
//   the merge. Each warp owns 16 rows of every tile of TILE rows and streams
//   them itself: a ring of STAGES slots of its own in shared memory, filled
//   by cp.async (16 bytes a lane, rows past the piece zero-filled, not read)
//   STAGES - 1 tiles ahead of its math and waited on per warp, so no block
//   barrier stalls the loads. What the loads need is many warps issuing
//   them: on an H100 at the 2B decode shape one producer warp feeding a
//   10-slot ring for four consumer warps took 41.7 us, where every warp
//   streaming its own rows takes 18.4. No TMA: a tensor map per layer and
//   step would cost host time on a path bound by the host, and bulk copies
//   of one 256-byte row each ran at 0.5 TB/s.
// - The wide form, where each window is one piece and the (kv head, sample)
//   pairs are no more than the SMs (Phi-3-mini's decode step: 4 x 32 pairs
//   of G = 1 at D = 96; the 2B step at B = 16: 16 x 8). There the split form
//   runs one block of 4 warps an SM, and on an H100 its rate stayed at 2.5
//   TB/s whatever its ring's depth (3 to 8 slots; 2 pieces, 256 blocks, the
//   same). The wide form runs one block of 8 warps an SM over a whole window
//   with a ring of 2 (one tile ahead: deeper rings read slower), the two
//   blocks of kv heads 2k and 2k + 1 of a sample as one cluster that moves
//   in step, tile by tile (a split cluster barrier: arrive after issuing the
//   next tile, wait before the one after), so that the two heads' rows of
//   each token are read together (where Hkv is odd, or the pairs do not all
//   fit on the card at once, each block is a cluster of its own); the copies
//   ask L2 to fetch the whole 128-byte line and to evict it first (read
//   once; the line's other bytes reach L2 only, the kernel reads the
//   window's rows alone). The warps' states merge in the block, with no
//   cluster merge.
// - The math runs on the tensor cores: S = Q K^T for the warp's 16 rows is
//   mma.sync m16n8k16 with the G query heads as the A rows (padded to 16
//   with zeros, held in registers), K through ldmatrix; the warp's online
//   softmax runs on the accumulator fragments (rows reduced over a quad of
//   lanes), and P, rounded to bf16 as the TPU kernel rounds it, times V is a
//   second mma with P's accumulators as the A fragment. A first version of
//   this kernel did the products on the CUDA cores, 8 values a lane with
//   shuffle reductions and a block barrier per tile: without its loads it
//   alone took 13.4 us at that shape, more than the bytes' 10.3.
// - After the last tile the warps' states merge through shared memory. In
//   the split form the nsplit blocks of a (kv head, sample) form one
//   thread-block cluster: each block pushes its state, output by output,
//   into the shared memory of the block that owns the output (distributed
//   shared memory); after one cluster barrier every owner merges the nsplit
//   states it holds. No scratch in device memory, no counter, no second
//   launch: the launch can be captured in a CUDA graph and replayed as it
//   is.
// - The current token: its k and v rows are copied into shared memory with
//   the first tile; after its loop the first warp computes the G scores
//   q . k_new * scale in fp32 from the A fragments; the owner takes
//   m_new = max(m, s_new) and
//   out = (acc * e^(m - m_new) + e^(s_new - m_new) * v_new) /
//         (l * e^(m - m_new) + e^(s_new - m_new))
//   in fp32 from the unnormalised accumulator, then one bf16 rounding.
//
// Against the TPU kernel's numbers. Kept: scores from an fp32 dot product,
// scaled by D^-0.5 in fp32; p rounded to the cache dtype for p * v, l the sum
// of the fp32 p; masked rows contribute nothing (they are never loaded,
// where the TPU kernel sets them to -1e30); out = acc / l, or 0 where
// l == 0; m and l of the window only. Changed: the merge with the current
// token runs on the fp32 state, where JAX's `merge_new_token` takes the
// window's output already rounded to bf16 and rounds again after the merge:
// one rounding fewer, a difference below out's own bf16 rounding. exp is
// __expf (ex2.approx): a few fp32 ulps on arguments <= 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_fragments.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GMAX = 16;          // query heads per kv head: the A rows
constexpr int MAX_SPLITS = 16;    // a cluster of 16 blocks: the non-portable size
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int WIDE_WARPS = 8;     // the wide form's warps
constexpr int WIDE_STAGES = 2;    // the wide form's ring: one tile ahead
constexpr float NEG = -1e30f;

struct Params {
  const __nv_bfloat16 *q, *k, *v, *k_new, *v_new;
  const int *starts, *end;
  __nv_bfloat16* out;
  float *m, *l;
  int hq, hkv, max_len, nsplit;
  long long q_sb, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, kn_sb, kn_sh, vn_sb, vn_sh;
  float scale;
};

// Beside the rings: the current token's k and v rows [2][D] bf16; written by
// every block of the cluster, the inbox of this block's share of the
// outputs, acc [nsplit][share] (nsplit * share < G * D + nsplit) and m, l
// [nsplit][G]; then the current token's scores [G]. Sized for the launch's G
// and nsplit: in the split form two blocks share an SM.
template <int D>
constexpr int extra_bytes(int g, int nsplit) {
  return 4 * D + (g * D + nsplit + 2 * nsplit * g + g) * 4;
}

// The launch's two forms (see "Design"). The split form: two blocks to an
// SM, 4 warps each with a ring of 3 slots. The wide form: one block an SM
// over a whole window, WIDE_WARPS warps each with a ring of WIDE_STAGES.
template <int D, bool WIDE>
struct Form {
  static constexpr int NWARPS = WIDE ? WIDE_WARPS : 4;  // each streams 16 rows of a tile
  static constexpr int NTHREADS = 32 * NWARPS;
  static constexpr int TILE = 16 * NWARPS;  // rows of a tile
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;  // blocks an SM
  static constexpr int LD = D + PAD;        // padded rows: ldmatrix without bank conflicts
  static_assert(D % 16 == 0 && (LD * 2) % 16 == 0, "rows of whole 16-byte vectors");
  static constexpr int SLOT = 2 * 16 * LD;  // bf16: a warp's 16 K rows, then its 16 V rows
  static constexpr int STAGES = WIDE ? WIDE_STAGES : 3;
  static_assert(STAGES >= 2, "a ring of at least two slots");
  static constexpr int RING = NWARPS * STAGES * SLOT * 2;  // bytes
  // after the loop the rings hold the warps' states
  static constexpr int WARP_STATE = (NWARPS * GMAX * D + 2 * NWARPS * GMAX) * 4;
  static_assert(WARP_STATE <= RING, "the warps' states must fit in the ring");
  static constexpr int MAX_BYTES = RING + extra_bytes<D>(GMAX, MAX_SPLITS);
  static_assert(MAX_BYTES <= SMEM_LIMIT, "a block's shared memory");
  static constexpr int bytes(int g, int nsplit) { return RING + extra_bytes<D>(g, nsplit); }
};

// 16 bytes global -> shared, bypassing L1; with valid == false nothing is
// read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// An L2 policy for data read once: evicted first.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// cp_async_16 for data read once: L2 fetches the whole 128-byte line around
// the 16 bytes and evicts it first (`policy` from l2_evict_first)
__device__ __forceinline__ void cp_async_16_once(void* dst, const void* src, bool valid,
                                                 uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint.L2::128B [%0], [%1], 16, %2, %3;\n" ::
                   "r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A cluster barrier in two halves. The split form's blocks arrive at their
// start and wait before their first write into another block's shared
// memory, which then exists (all blocks of a cluster have started); the wide
// form's pair arrives after issuing each tile and waits before issuing the
// next but one.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int D, bool MERGE, bool WIDE>
__global__ void __launch_bounds__((Form<D, WIDE>::NTHREADS), (Form<D, WIDE>::MIN_BLOCKS))
    decode_attention_kernel(const Params p) {
  using S = Form<D, WIDE>;
  constexpr int LD = S::LD, NWARPS = S::NWARPS, NTHREADS = S::NTHREADS, TILE = S::TILE,
                STAGES = S::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int z = WIDE ? 0 : static_cast<int>(cluster.block_rank());  // blockIdx.y
  const int G = p.hq / p.hkv;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kn_s = reinterpret_cast<__nv_bfloat16*>(smem + S::RING);
  __nv_bfloat16* vn_s = kn_s + D;
  float* in_acc = reinterpret_cast<float*>(smem + S::RING + 4 * D);
  float* in_m = in_acc + G * D + p.nsplit;
  float* in_l = in_m + p.nsplit * G;
  float* st_snew = in_l + p.nsplit * G;
  const int h = blockIdx.x, head0 = h * G, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // this block's rows [lo, hi) of the sample's window [start, end)
  const int end = min(*p.end, p.max_len);
  const int start = max(p.starts[b], 0);
  const int n = max(end - start, 0);
  const int per = (n + p.nsplit - 1) / p.nsplit;
  const int lo = start + z * per;
  const int hi = min(lo + per, end);
  const int tiles = hi > lo ? (hi - lo + TILE - 1) / TILE : 0;

  if constexpr (!WIDE) cluster_arrive_relaxed();
  // this warp's rows of tile t: [lo + t * TILE + 16 * warp, + 16), into slot
  // t % STAGES of its ring; rows past the piece are zero-filled, not read
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* wring = ring + warp * STAGES * S::SLOT;
  const uint64_t policy = WIDE ? l2_evict_first() : 0;
  auto issue = [&](int t) {
    __nv_bfloat16* slot = wring + (t % STAGES) * S::SLOT;
    constexpr int CHUNKS = D / 8;  // 16-byte vectors a row
#pragma unroll
    for (int i = 0; i < 2 * 16 * CHUNKS / 32; ++i) {
      const int c = lane + 32 * i;
      const int kv = c / (16 * CHUNKS), r = (c / CHUNKS) % 16, cc = (c % CHUNKS) * 8;
      const int row = lo + t * TILE + warp * 16 + r;
      const bool ok = row < hi;
      const long long at = ok ? row : lo;
      __nv_bfloat16* dst = slot + (kv * 16 + r) * LD + cc;
      const __nv_bfloat16* src = (kv ? vb + at * p.v_sr : kb + at * p.k_sr) + cc;
      if constexpr (WIDE)
        cp_async_16_once(dst, src, ok, policy);
      else
        cp_async_16(dst, src, ok);
    }
  };
  if (MERGE && tid < D / 4) {  // read after the loop, landed with the first tile
    const int c = tid % (D / 8) * 8;
    cp_async_16((tid < D / 8 ? kn_s : vn_s) + c,
                tid < D / 8 ? p.k_new + b * p.kn_sb + h * p.kn_sh + c
                            : p.v_new + b * p.vn_sb + h * p.vn_sh + c,
                true);
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) issue(t);
    cp_async_commit();  // empty groups keep the count of groups in step
  }
  // a warp's state: rows gq and gq + 8 of the A fragments
  const int gq = lane / 4, tq = lane % 4;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  {
    // the G query rows as the A fragments, rows past G zero
    uint32_t qa[D / 16][4];
    const __nv_bfloat16* q0 = p.q + b * p.q_sb + (head0 + gq) * p.q_sh + 2 * tq;
    const __nv_bfloat16* q8 = q0 + 8 * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = gq < G ? *reinterpret_cast<const uint32_t*>(q0 + kk * 16) : 0u;
      qa[kk][1] = gq + 8 < G ? *reinterpret_cast<const uint32_t*>(q8 + kk * 16) : 0u;
      qa[kk][2] = gq < G ? *reinterpret_cast<const uint32_t*>(q0 + kk * 16 + 8) : 0u;
      qa[kk][3] = gq + 8 < G ? *reinterpret_cast<const uint32_t*>(q8 + kk * 16 + 8) : 0u;
    }
    for (int t = 0; t < tiles; ++t) {
      if constexpr (WIDE) {  // every warp of the cluster has issued tile t
        if (t > 0) cluster_wait();
      }
      cp_async_wait<STAGES - 2>();  // this lane's copies of tile t have landed
      __syncwarp();                 // ... and the warp's; slot t - 1 is free
      if (t + STAGES - 1 < tiles) issue(t + STAGES - 1);
      cp_async_commit();
      if constexpr (WIDE) cluster_arrive_relaxed();
      const __nv_bfloat16* ks = wring + (t % STAGES) * S::SLOT;
      const __nv_bfloat16* vs = ks + 16 * LD;
      float sc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        load_b_rows<LD>(bk, ks, 0, kk * 16, lane);
        mma_16816(sc[0], qa[kk], bk[0], bk[1]);
        mma_16816(sc[1], qa[kk], bk[2], bk[3]);
      }
      // scale and mask; the rows' maxima over the quad's 16 columns
      const int key0 = lo + t * TILE + warp * 16 + 2 * tq;
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key0 + nt * 8 + (e & 1) < hi;
          sc[nt][e] = ok ? sc[nt][e] * p.scale : NEG;
          mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = __expf(m_r[r] - m_new);
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
      float pr[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pr[nt][e] = sc[nt][e] > 0.5f * NEG ? __expf(sc[nt][e] - m_r[e / 2]) : 0.f;
          l_r[e / 2] += pr[nt][e];
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      const uint32_t pa[4] = {pack_f32(pr[0][0], pr[0][1]), pack_f32(pr[0][2], pr[0][3]),
                              pack_f32(pr[1][0], pr[1][1]), pack_f32(pr[1][2], pr[1][3])};
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t bv[4];
        load_b_cols<LD>(bv, vs, 0, j * 16, lane);
        mma_16816(o[2 * j], pa, bv[0], bv[1]);
        mma_16816(o[2 * j + 1], pa, bv[2], bv[3]);
      }
    }
    if constexpr (WIDE) {
      if (tiles > 0) cluster_wait();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // each lane summed its own columns
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    if (MERGE && warp == 0) {
      // the current token's scores q . k_new * scale in fp32: a quad holds a
      // query row's D values in its A fragments; its lanes take the same
      // columns of k_new and sum over the quad
      cp_async_wait<0>();  // k_new's copies, in an empty block too
      __syncwarp();
      float d0 = 0.f, d8 = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 k2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              kn_s + kk * 16 + 8 * half + 2 * tq));
          const float2 a0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][2 * half]));
          const float2 a8 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][2 * half + 1]));
          d0 = fmaf(a0.x, k2.x, fmaf(a0.y, k2.y, d0));
          d8 = fmaf(a8.x, k2.x, fmaf(a8.y, k2.y, d8));
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, off);
        d8 += __shfl_xor_sync(0xffffffffu, d8, off);
      }
      if (tq == 0 && gq < G) st_snew[gq] = d0 * p.scale;
      if (tq == 0 && gq + 8 < G) st_snew[gq + 8] = d8 * p.scale;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every slot is consumed: the rings are free for the warps' states

  float* w_acc = reinterpret_cast<float*>(smem);  // [NWARPS][GMAX][D]
  float* w_m = w_acc + NWARPS * GMAX * D;         // [NWARPS][GMAX]
  float* w_l = w_m + NWARPS * GMAX;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    if (row >= G) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      w_acc[(warp * GMAX + row) * D + j * 8 + 2 * tq] = o[j][2 * r];
      w_acc[(warp * GMAX + row) * D + j * 8 + 2 * tq + 1] = o[j][2 * r + 1];
    }
    if (tq == 0) {
      w_m[warp * GMAX + row] = m_r[r];
      w_l[warp * GMAX + row] = l_r[r];
    }
  }
  __syncthreads();

  // the warps' states into the block's, unnormalised; in the wide form
  // that is the window's, stored at once, and in the split form it is pushed
  // into the inbox of the block that owns each output
  if constexpr (WIDE) {
    for (int i = tid; i < G * D; i += NTHREADS) {
      const int g = i / D, d = i % D;
      float m_all = NEG;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) m_all = fmaxf(m_all, w_m[w * GMAX + g]);
      float l_all = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float e = __expf(w_m[w * GMAX + g] - m_all);
        l_all += w_l[w * GMAX + g] * e;
        a += w_acc[(w * GMAX + g) * D + d] * e;
      }
      const long long o_idx = (static_cast<long long>(b) * p.hq + head0 + g) * D + d;
      if (MERGE) {
        const float s_new = st_snew[g];
        const float m_new = fmaxf(m_all, s_new);
        const float alpha = __expf(m_all - m_new), p_new = __expf(s_new - m_new);
        const float vn = __bfloat162float(vn_s[d]);
        p.out[o_idx] = __float2bfloat16_rn((a * alpha + p_new * vn) / (l_all * alpha + p_new));
      } else {
        p.out[o_idx] = __float2bfloat16_rn(l_all > 0.f ? a / l_all : 0.f);
        if (d == 0) {
          p.m[o_idx / D] = m_all;
          p.l[o_idx / D] = l_all;
        }
      }
    }
    return;
  }

  const int share = (G * D + p.nsplit - 1) / p.nsplit;
  cluster_wait();  // every block of the cluster has started
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D;
    float m_all = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_all = fmaxf(m_all, w_m[w * GMAX + g]);
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float e = __expf(w_m[w * GMAX + g] - m_all);
      l_all += w_l[w * GMAX + g] * e;
      a += w_acc[(w * GMAX + g) * D + i % D] * e;
    }
    const int owner = i / share;
    *cluster.map_shared_rank(in_acc + z * share + i - owner * share, owner) = a;
    if (i % D == 0) {
      for (int r = 0; r < p.nsplit; ++r) {
        *cluster.map_shared_rank(in_m + z * G + g, r) = m_all;
        *cluster.map_shared_rank(in_l + z * G + g, r) = l_all;
      }
    }
  }
  // every push has landed; after this no block touches another's memory
  cluster.sync();

  // this block's share of the G * D outputs, from the nsplit states
  const int i_end = min((z + 1) * share, G * D);
  for (int i = z * share + tid; i < i_end; i += NTHREADS) {
    const int g = i / D, d = i % D, j = i - z * share;
    float m_all = NEG;
    for (int r = 0; r < p.nsplit; ++r) m_all = fmaxf(m_all, in_m[r * G + g]);
    float l_all = 0.f, a = 0.f;
    for (int r = 0; r < p.nsplit; ++r) {
      const float e = __expf(in_m[r * G + g] - m_all);
      l_all += in_l[r * G + g] * e;
      a += in_acc[r * share + j] * e;
    }
    const long long o_idx = (static_cast<long long>(b) * p.hq + head0 + g) * D + d;
    if (MERGE) {
      const float s_new = st_snew[g];
      const float m_new = fmaxf(m_all, s_new);
      const float alpha = __expf(m_all - m_new), p_new = __expf(s_new - m_new);
      const float vn = __bfloat162float(vn_s[d]);
      p.out[o_idx] = __float2bfloat16_rn((a * alpha + p_new * vn) / (l_all * alpha + p_new));
    } else {
      p.out[o_idx] = __float2bfloat16_rn(l_all > 0.f ? a / l_all : 0.f);
      if (d == 0) {
        p.m[o_idx / D] = m_all;
        p.l[o_idx / D] = l_all;
      }
    }
  }
}

template <int D, bool MERGE, bool WIDE>
int launch(const Params& p, int B, cudaStream_t stream) {
  using F = Form<D, WIDE>;
  auto kernel = decode_attention_kernel<D, MERGE, WIDE>;
  const int bytes = F::bytes(p.hq / p.hkv, p.nsplit);
  // set once per device: the host cost of a decode step counts
  static bool ready[64] = {};
  static int pairs[64] = {};  // the wide form's clusters of two that fit at once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F::MAX_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (WIDE) {
      cudaLaunchConfig_t two = {};
      two.gridDim = dim3(2);
      two.blockDim = dim3(F::NTHREADS);
      two.dynamicSmemBytes = F::MAX_BYTES;
      cudaLaunchAttribute pair[1];
      pair[0].id = cudaLaunchAttributeClusterDimension;
      pair[0].val.clusterDim.x = 2;
      pair[0].val.clusterDim.y = pair[0].val.clusterDim.z = 1;
      two.attrs = pair;
      two.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&pairs[dev], kernel, &two);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.hkv, p.nsplit, B);
  cfg.blockDim = dim3(F::NTHREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  // the split form: the pieces of a window; the wide form: two kv heads of a
  // sample, where every pair fits on the card at once
  const bool pair = WIDE && p.hkv % 2 == 0 && B * p.hkv / 2 <= pairs[dev];
  attr[0].val.clusterDim.x = pair ? 2 : 1;
  attr[0].val.clusterDim.y = p.nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, int B, bool wide, cudaStream_t stream) {
  if (wide)
    return p.k_new ? launch<D, true, true>(p, B, stream) : launch<D, false, true>(p, B, stream);
  return p.k_new ? launch<D, true, false>(p, B, stream) : launch<D, false, false>(p, B, stream);
}

}  // namespace

extern "C" {

// Returns 0 on success, else the cudaError_t of the failed launch. Dtypes,
// shapes and devices are checked by the Python wrapper; alignment here.
// Strides are in elements. With k_new and v_new (both or neither) the
// current token is merged and m, l are not written; without them m and l
// receive the window's softmax state. `wide` (0 or 1, the last argument)
// picks the wide form over the split form.
int aigv_cached_decode_attention(const void* q, const void* k, const void* v,
                                 const void* k_new, const void* v_new, const void* starts,
                                 const void* end, void* out, void* m, void* l, int B, int hq,
                                 int hkv, int max_len, int D, int nsplit, long long q_sb,
                                 long long q_sh, long long k_sb, long long k_sr, long long k_sh,
                                 long long v_sb, long long v_sr, long long v_sh,
                                 long long kn_sb, long long kn_sh, long long vn_sb,
                                 long long vn_sh, float scale, void* stream, int wide) {
  const bool merge = k_new != nullptr;
  if (B <= 0 || hkv <= 0 || hq <= 0 || hq % hkv || hq / hkv > GMAX || max_len <= 0 ||
      nsplit <= 0 || nsplit > MAX_SPLITS || B > 65535 || hkv > 65535 ||
      merge != (v_new != nullptr) || (!merge && (m == nullptr || l == nullptr)) ||
      (wide != 0 && wide != 1) || (wide && nsplit != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads: aligned bases, row strides in whole 16-byte vectors
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(k_new) |
                          reinterpret_cast<uintptr_t>(v_new);
  const long long strides = q_sb | q_sh | k_sb | k_sr | k_sh | v_sb | v_sr | v_sh |
                            (merge ? kn_sb | kn_sh | vn_sb | vn_sh : 0);
  if (bases % 16 || strides % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  const Params p{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<const __nv_bfloat16*>(k_new),
                 static_cast<const __nv_bfloat16*>(v_new),
                 static_cast<const int*>(starts),
                 static_cast<const int*>(end),
                 static_cast<__nv_bfloat16*>(out),
                 static_cast<float*>(m),
                 static_cast<float*>(l),
                 hq, hkv, max_len, nsplit,
                 q_sb, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, kn_sb, kn_sh, vn_sb, vn_sh,
                 scale};
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_d<128>(p, B, wide, st);
  if (D == 96) return launch_d<96>(p, B, wide, st);
  if (D == 64) return launch_d<64>(p, B, wide, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
