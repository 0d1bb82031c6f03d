// Weight-only quantized matmuls (W8A16, W4A16) for sm_90a: bf16 activations
// against int8 or nibble-packed int4 weights that are decoded inside the
// kernel, never into device memory.
//
// Replaces the Pallas TPU kernels of aigv_assessor_tpu/ops/int8_matmul.py:
// `_kernel` (through `int8_matmul`) and `_int4_kernel` (through
// `int4_matmul`).
//
//   y[M, N] = bf16( (x[M, K] @ decode(w)[N, K]^T) * scale[N] (+ bias[N]) )
//
//   x      bf16 [M, K], row stride ldx elements.
//   w      int8, one row per output channel, row stride ldw bytes:
//          int8: [N, K], byte k of row n is weight (k, n);
//          int4: [N, ceil(K/2)], byte j of row n packs weights (2j, n) in
//          its low nibble and (2j + 1, n) in its high nibble, both signed.
//          This is the TPU kernels' [K, N] / [ceil(K/2), N] layout
//          transposed, so that the K values of one output channel are
//          contiguous.
//   scale  fp32 [N], applied to the fp32 sum; bias bf16 [N] or null, added
//          in fp32; the result is rounded to bf16 once.
//   M, N and K are any size. Edges are zero-filled here, not padded by the
//   caller: a zero weight byte decodes to 0 in both formats, and x is
//   zero-filled beyond K and M.
//
// Every form decodes a weight byte the same way, exactly: a byte biased to
// unsigned goes into the mantissa of 2^23 as an fp32, the bias is subtracted
// (exact), and the top 16 bits of the result are its bf16 (exact for |q| <=
// 128). That is integer and fp32 work, without conversion instructions. The
// forms differ only in the order of the fp32 sum.
//
// Three forms, one C entry point each, chosen by the Python wrapper from the
// shapes, the strides and the pointers (`ops/int8_matmul.weight_only_form`):
//
// GEMM (more rows than the decode threshold; x and w as TMA can describe
// them: 16-byte aligned bases and row strides). What bounds it: at the
// prefill shapes (M = 8452, K and N in the thousands) the product is
// compute-bound, above a thousand FLOP per byte, so the bound is the tensor
// cores' bf16 rate, and the decode must not take the tensor cores' time. The
// design swaps the operands, y^T = w . x^T, and decodes in registers: one
// persistent block per SM walks tiles of 128 channels x 256 rows of x (n
// within m), 64 K per step, warp-specialised:
// - one producer thread: TMA loads into two rings with full and empty
//   mbarriers: x tiles (bf16 [256 rows][64], 128-byte swizzle, K-major; 4
//   stages) and raw weight tiles ([128 channels][128 bytes], 128-byte
//   swizzle: 2 int8 or 4 int4 steps a load; 4 stages). The maps are encoded
//   on the host per call (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so nothing links libcuda); TMA zero-fills beyond
//   M, N and the row's bytes, so the tails need no code;
// - two consumer warpgroups of 64 channels each: per k16, wgmma m64n256k16
//   with the weight as the register-sourced A operand and the x tile as B
//   from shared memory. A lane's A fragment holds K positions {2t, 2t + 1,
//   2t + 8, 2t + 9} of two channel rows, which the storage layout does not
//   keep together: ldmatrix brings each lane 4 bytes of a row's 16-byte
//   chunk, two (int8) or four (int4) shuffles within the lane's quad gather
//   its own bytes, and the exact decode makes them bf16 pairs, nothing
//   repacked beforehand. A warpgroup makes a step's fragments while the
//   other's products run on the tensor cores. The epilogue applies scale[n]
//   and bias[n] in fp32 (the accumulator's rows are channels), rounds once
//   and stores directly, predicated (rows of y need not be aligned: the LM
//   head's 92553 columns are not), while the producer already fills the
//   next tile's stages.
// The first design decoded on the producer side: decode warps wrote each
// step's bf16 weight tile into shared memory in the 128-byte swizzle for SS
// products (A = x, B = the decoded tile). On an H100 its best form (256 x
// 128 tiles, 4 decoded tiles, 3 decode warps) took 1.2-1.25x this one's time
// (PERF.md): the decoded tile's writes and the products' reads of it were
// shared-memory traffic this form does not have, and its decode warps set
// the pace.
//
// GEMV (M at or below the decode threshold): the decode matvec of
// decode_matvec.cuh, shared with the fp8 matmul (fp8_matmul.cu). What bounds
// it: the weight bytes, read once. 16 channels x 8 rows of x per mma.sync
// with the operands swapped, 8 warps splitting K with 16-byte loads straight
// into registers. A 16-byte int8 load holds 16 K positions and a 16-byte int4
// load 32; each 4-byte word decodes to bf16 pairs of consecutive K, the int4
// nibbles low first, and x is read in that order.
//
// Unaligned (whatever TMA cannot describe, e.g. an odd K with x's rows off 16
// bytes): the original body. One block of 8 warps per 128 x 128 tile of y,
// looping over K in steps of 32; each step's x tile and decoded weight tile
// sit in shared memory as bf16, the next step's tiles read into registers
// while the current ones are multiplied (two buffers, one __syncthreads per
// step), the bytes decoded on the way from registers to shared memory (the
// int4 [BN, BK/2] byte tile becomes a [BN, BK] bf16 tile, nibbles in
// neighbouring K positions); mma.sync m16n8k16 with fp32 accumulation,
// fragments through ldmatrix (mma_fragments.cuh). Loads are 16 bytes wide
// when the pointers, the row strides and K allow it, otherwise gathered byte
// by byte. It is far from the tensor-core rate (mma.sync, register-staged
// loads, one barrier per 32 K) and meant for odd shapes only.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_matvec.cuh"
#include "hopper.cuh"
#include "mma_fragments.cuh"

namespace {

enum Bits { INT8 = 8, INT4 = 4 };

// ------------------------------------------------- the exact byte decode --

// The four bytes of u, each a small unsigned integer, as floats minus
// `bias - 2^23`: byte b becomes the fp32 with mantissa b and exponent 23,
// which is 2^23 + b exactly.
__device__ __forceinline__ void bytes_to_floats(uint32_t u, float bias, float (&f)[4]) {
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
}

// two floats that bf16 holds exactly -> one register of two bf16, `lo` in
// the low half: their top 16 bits
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// four int8 weights of consecutive K -> four bf16
__device__ __forceinline__ uint2 decode_int8(uint32_t w) {
  float f[4];
  bytes_to_floats(w ^ 0x80808080u, 8388608.f + 128.f, f);
  return make_uint2(pack_exact(f[0], f[1]), pack_exact(f[2], f[3]));
}

// four bytes = eight int4 weights of consecutive K (low nibble first) ->
// eight bf16. A two's-complement nibble q is (q + 8) after flipping bit 3.
__device__ __forceinline__ uint4 decode_int4(uint32_t w) {
  float lo[4], hi[4];
  bytes_to_floats((w & 0x0F0F0F0Fu) ^ 0x08080808u, 8388608.f + 8.f, lo);
  bytes_to_floats(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8388608.f + 8.f, hi);
  return make_uint4(pack_exact(lo[0], hi[0]), pack_exact(lo[1], hi[1]),
                    pack_exact(lo[2], hi[2]), pack_exact(lo[3], hi[3]));
}

// ----------------------------------------------------------- unaligned form --

namespace unaligned {

constexpr int BM = 128;  // rows of y per block
constexpr int BN = 128;  // columns of y per block
constexpr int BK = 32;   // K per step
constexpr int NTHREADS = 256;
constexpr int LD = BK + PAD;  // smem row stride, elements
constexpr int WM = 64;        // rows per warp: warps are laid out 2 x 4
constexpr int WN = 32;        // columns per warp
constexpr int A_CHUNKS = BM * BK / 8 / NTHREADS;  // 16-byte chunks of x per thread: 2

// 16 bytes of a row starting at byte `off`; zero where the row does not
// exist or the bytes lie at or beyond `valid`. With `vec`, valid is a
// multiple of 16 and the address is 16-byte aligned.
__device__ __forceinline__ uint4 load_chunk(const unsigned char* __restrict__ row, long long off,
                                            long long valid, bool row_ok, bool vec) {
  if (!row_ok || off >= valid) return make_uint4(0, 0, 0, 0);
  if (vec) return *reinterpret_cast<const uint4*>(row + off);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (off + i < valid) w[i >> 2] |= static_cast<uint32_t>(row[off + i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BITS>
__global__ void __launch_bounds__(NTHREADS, 2)
weight_only_matmul_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w,
                          const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ y, int M, int N, int K, long long ldx,
                          long long ldw, long long ldy, bool vec_x, bool vec_w) {
  // int8: two 16-byte chunks (16 K each) per weight row and step, one per
  // thread; int4: one chunk (32 K) per row, threads 0..BN-1
  constexpr int W_CHUNKS = BITS == INT8 ? 2 : 1;
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM * LD];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BN * LD];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;

  const auto* xb = reinterpret_cast<const unsigned char*>(x);
  const long long x_valid = 2LL * K;                         // bytes of one x row
  const long long w_valid = BITS == INT8 ? K : (K + 1) / 2;  // bytes of one weight row
  const int w_row = tid / W_CHUNKS, w_chunk = tid % W_CHUNKS;
  const bool w_loads = tid < BN * W_CHUNKS;

  uint4 ra[A_CHUNKS], rb = make_uint4(0, 0, 0, 0);
  auto load_tile = [&](int kt) {
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (BK / 8), c = i % (BK / 8);
      ra[j] = load_chunk(xb + (m0 + r) * ldx * 2, (static_cast<long long>(kt) * BK + c * 8) * 2,
                         x_valid, m0 + r < M, vec_x);
    }
    if (w_loads)
      rb = load_chunk(w + (n0 + w_row) * ldw,
                      static_cast<long long>(kt) * (BK * BITS / 8) + w_chunk * 16, w_valid,
                      n0 + w_row < N, vec_w);
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (BK / 8), c = i % (BK / 8);
      *reinterpret_cast<uint4*>(&sA[buf][r * LD + c * 8]) = ra[j];
    }
    if (w_loads) {
      __nv_bfloat16* dst = &sB[buf][w_row * LD + w_chunk * 16];
      if constexpr (BITS == INT8) {
        const uint2 d0 = decode_int8(rb.x), d1 = decode_int8(rb.y);
        const uint2 d2 = decode_int8(rb.z), d3 = decode_int8(rb.w);
        *reinterpret_cast<uint4*>(dst) = make_uint4(d0.x, d0.y, d1.x, d1.y);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(d2.x, d2.y, d3.x, d3.y);
      } else {
        *reinterpret_cast<uint4*>(dst) = decode_int4(rb.x);
        *reinterpret_cast<uint4*>(dst + 8) = decode_int4(rb.y);
        *reinterpret_cast<uint4*>(dst + 16) = decode_int4(rb.z);
        *reinterpret_cast<uint4*>(dst + 24) = decode_int4(rb.w);
      }
    }
  };

  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_steps = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < n_steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_steps) load_tile(kt + 1);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[WM / 16][4], bf[WN / 16][4];
#pragma unroll
      for (int mt = 0; mt < WM / 16; ++mt) load_a<LD>(af[mt], sA[buf], wm + mt * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < WN / 16; ++np)
        load_b_rows<LD>(bf[np], sB[buf], wn + np * 16, ks * 16, lane);
#pragma unroll
      for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt)
          mma_16816(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
    // the other buffer was last read in the previous step, before its barrier
    if (kt + 1 < n_steps) store_tile(buf ^ 1);
    __syncthreads();
  }

  // y = acc * scale (+ bias) in fp32, rounded to bf16 once. Two neighbouring
  // columns go out as one 4-byte store when every row of y keeps them aligned.
  const int gr = lane >> 2, tq = lane & 3;
  const bool pair_ok = ldy % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < WN / 8; ++nt) {
    const int c = n0 + wn + nt * 8 + tq * 2;
    if (c >= N) continue;
    const bool two = c + 1 < N;
    const float s0 = scale[c], s1 = two ? scale[c + 1] : 0.f;
    const float b0 = bias != nullptr ? __bfloat162float(bias[c]) : 0.f;
    const float b1 = bias != nullptr && two ? __bfloat162float(bias[c + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < WM / 16; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + gr + half * 8;
        if (r >= M) continue;
        const float v0 = acc[mt][nt][2 * half] * s0 + b0;
        const float v1 = acc[mt][nt][2 * half + 1] * s1 + b1;
        __nv_bfloat16* dst = y + r * ldy + c;
        if (two && pair_ok) {
          *reinterpret_cast<uint32_t*>(dst) = pack_f32(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (two) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int BITS>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* y, int M,
           int N, int K, long long ldx, long long ldw, long long ldy, void* stream) {
  const long long w_bytes = BITS == INT8 ? K : (K + 1) / 2;
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < w_bytes || ldy < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0 && K % 8 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0 && w_bytes % 16 == 0;
  weight_only_matmul_kernel<BITS><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, ldx, ldw, ldy, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace unaligned

// ---------------------------------------------------------------- GEMV form --

// the weight formats of decode_matvec.cuh
struct Int8Weights {
  static constexpr int KPB = 1;
  static __device__ __forceinline__ void convert(uint32_t word, uint32_t (&pairs)[2]) {
    const uint2 d = decode_int8(word);
    pairs[0] = d.x, pairs[1] = d.y;
  }
};

struct Int4Weights {
  static constexpr int KPB = 2;
  static __device__ __forceinline__ void convert(uint32_t word, uint32_t (&pairs)[4]) {
    const uint4 d = decode_int4(word);
    pairs[0] = d.x, pairs[1] = d.y, pairs[2] = d.z, pairs[3] = d.w;
  }
};

// ---------------------------------------------------------------- GEMM form --

namespace gemm {

using namespace hopper;

constexpr int BM = 256;          // rows of x per tile: the products' n
constexpr int BN = 128;          // channels per tile: two consumer warpgroups of 64
constexpr int BK = 64;           // K per step: one 128-byte swizzle row of bf16 x
constexpr int RAW_BYTES = 128;   // weight bytes of a channel per raw load: 2 / 4 steps
constexpr int X_STAGES = 4;      // x tiles in flight
constexpr int R_STAGES = 4;      // raw weight tiles in flight
constexpr int THREADS = 256 + 32;  // two consumer warpgroups, then the producer warp

template <int BITS>
struct Fmt {
  static constexpr int STEP_BYTES = BITS == INT8 ? BK : BK / 2;  // bytes of a channel a step
  static constexpr int STEPS_PER_RAW = RAW_BYTES / STEP_BYTES;
};

// Shared memory of one block, in bytes from a 1024-byte aligned base: the x
// ring, the raw ring, then the barriers: 192 KB.
struct Smem {
  static constexpr int X = BM * BK * 2;
  static constexpr int R = BN * RAW_BYTES;
  static constexpr int R_OFF = X_STAGES * X;
  static constexpr int BAR_OFF = R_OFF + R_STAGES * R;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * (X_STAGES + R_STAGES) + 1024;
};

struct Barriers {
  uint64_t* xfull;   // [X_STAGES] x tile landed (TMA)
  uint64_t* xempty;  // [X_STAGES] x tile multiplied
  uint64_t* rfull;   // [R_STAGES] raw tile landed (TMA)
  uint64_t* rempty;  // [R_STAGES] raw tile decoded
};

// Words of the quad (the four lanes of one fragment row): lane t of the
// quad holds bytes 4t .. 4t + 3 of a 16-byte chunk (ldmatrix). -> the pairs
// of bytes t and t + 4 (2t, 2t + 1 and 2t + 8, 2t + 9): the K positions of
// lane t's A fragment in a 16-wide step of int8
__device__ __forceinline__ uint32_t fragment_pairs(uint32_t word, int lane) {
  const int t = lane & 3, base = lane & ~3;
  const uint32_t lo = __shfl_sync(0xffffffff, word, base + (t >> 1));
  const uint32_t hi = __shfl_sync(0xffffffff, word, base + (t >> 1) + 2);
  return __byte_perm(lo, hi, (t & 1) ? 0x7632 : 0x5410);
}

// -> bytes t, t + 4, t + 8, t + 12 of the chunk: the nibbles of lane t's A
// fragments in two 16-wide steps of int4
__device__ __forceinline__ uint32_t fragment_bytes(uint32_t word, int lane) {
  const int t = lane & 3, base = lane & ~3;
  const uint32_t v0 = __shfl_sync(0xffffffff, word, base);
  const uint32_t v1 = __shfl_sync(0xffffffff, word, base + 1);
  const uint32_t v2 = __shfl_sync(0xffffffff, word, base + 2);
  const uint32_t v3 = __shfl_sync(0xffffffff, word, base + 3);
  const uint32_t sel = t | ((4 + t) << 4);
  return __byte_perm(__byte_perm(v0, v1, sel), __byte_perm(v2, v3, sel), 0x5410);
}

// The A fragments (the warp's 16 channels, 16 K each) of the 4 k16 steps of
// step `sub` of a raw tile ([BN][128 bytes], 128-byte swizzle), decoded in
// registers: ldmatrix brings each lane 4 bytes of a row's 16-byte chunk, the
// quad's shuffles put the lane's own K positions together, and the exact
// decode makes them bf16 pairs.
template <int BITS>
__device__ __forceinline__ void fragments(const unsigned char* raw, int sub, int row0, int lane,
                                          uint32_t (&a)[4][4]) {
  constexpr int CHUNKS = Fmt<BITS>::STEP_BYTES / 16;  // 16-byte chunks of a row a step
  const int mi = lane >> 3, row = row0 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
  for (int h = 0; h < CHUNKS / 2; ++h) {
    // chunks 2h and 2h + 1 of the step, rows row0 .. row0 + 7 and + 8 ..
    const int chunk = sub * CHUNKS + 2 * h + (mi >> 1);
    uint32_t w[4];  // (rows g, chunk 2h), (rows g + 8, 2h), (g, 2h + 1), (g + 8, 2h + 1)
    ldmatrix_x4<false>(w, reinterpret_cast<const __nv_bfloat16*>(
                              raw + row * RAW_BYTES + ((chunk ^ (row & 7)) << 4)));
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if constexpr (BITS == INT8) {  // a chunk is one k16 step
        const uint2 r0 = decode_int8(fragment_pairs(w[2 * q], lane));
        const uint2 r1 = decode_int8(fragment_pairs(w[2 * q + 1], lane));
        const int s = 2 * h + q;
        a[s][0] = r0.x, a[s][1] = r1.x, a[s][2] = r0.y, a[s][3] = r1.y;
      } else {  // a chunk is two k16 steps
        const uint4 r0 = decode_int4(fragment_bytes(w[2 * q], lane));
        const uint4 r1 = decode_int4(fragment_bytes(w[2 * q + 1], lane));
        const int s = 2 * (2 * h + q);
        a[s][0] = r0.x, a[s][1] = r1.x, a[s][2] = r0.y, a[s][3] = r1.y;
        a[s + 1][0] = r0.z, a[s + 1][1] = r1.z, a[s + 1][2] = r0.w, a[s + 1][3] = r1.w;
      }
    }
  }
}

// One consumer warpgroup: channels c * 64 .. c * 64 + 63 of every tile of
// the block, all BM rows of x. y^T = w . x^T: the decoded weight is the
// product's register-sourced A, x its B from shared memory. Each step's
// fragments are made while the other warpgroup's products run, and used
// before the next step's are made (one set of 16 registers: a second one
// would not fit the 168 beside the 128 of the accumulator).
template <int BITS>
__device__ __forceinline__ void consumer(const unsigned char* sX, const unsigned char* sR,
                                         Barriers bar, const float* __restrict__ scale,
                                         const __nv_bfloat16* __restrict__ bias,
                                         __nv_bfloat16* __restrict__ y, int M, int N,
                                         long long ldy, int n_tiles, int tiles, int k_steps,
                                         int c) {
  using F = Fmt<BITS>;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row0 = c * 64 + warp * 16;  // the warp's first channel of the tile
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4];  // the A fragments of a step's four k16 products
  int it = 0, jr = 0;  // steps and raw tiles so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    for (int ks = 0; ks < k_steps; ++ks, ++it) {
      const int sub = ks % F::STEPS_PER_RAW, rs = jr % R_STAGES, xs = it % X_STAGES;
      if (sub == 0) mbar_wait(bar.rfull + rs, (jr / R_STAGES) & 1);
      fragments<BITS>(sR + rs * Smem::R, sub, row0, lane, a);
      mbar_wait(bar.xfull + xs, (it / X_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_rs_n256(acc, a[s], make_desc_sw128(sX + xs * Smem::X + s * 32, 16, 1024),
                      ks > 0 || s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) fence_regs(a[s]);  // read by the products until here
      const bool raw_done = sub == F::STEPS_PER_RAW - 1 || ks == k_steps - 1;
      if (lane == 0) {  // one arrival per warp
        mbar_arrive(bar.xempty + xs);
        if (raw_done) mbar_arrive(bar.rempty + rs);
      }
      jr += raw_done;
    }

    // y = acc * scale (+ bias) in fp32, rounded to bf16 once: the
    // accumulator's rows are channels g and g + 8, its columns rows of x
    const int ch0 = n0 + row0 + g, ch1 = ch0 + 8;
    const float s0 = ch0 < N ? scale[ch0] : 0.f, s1 = ch1 < N ? scale[ch1] : 0.f;
    const float b0 = bias != nullptr && ch0 < N ? __bfloat162float(bias[ch0]) : 0.f;
    const float b1 = bias != nullptr && ch1 < N ? __bfloat162float(bias[ch1]) : 0.f;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = m0 + j * 8 + t * 2 + e;
        if (r >= M) continue;
        __nv_bfloat16* dst = y + static_cast<long long>(r) * ldy;
        if (ch0 < N) dst[ch0] = __float2bfloat16_rn(acc[4 * j + e] * s0 + b0);
        if (ch1 < N) dst[ch1] = __float2bfloat16_rn(acc[4 * j + 2 + e] * s1 + b1);
      }
    }
  }
}

// One persistent block per SM, tiles in order of n within m, so that the
// blocks in flight share the weight and few x rows through L2.
template <int BITS>
__global__ void __launch_bounds__(THREADS, 1)
weight_only_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw, const float* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                        int M, int N, int K, long long ldy) {
  using F = Fmt<BITS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sX = smem;
  unsigned char* sR = smem + Smem::R_OFF;
  Barriers bar;
  bar.xfull = reinterpret_cast<uint64_t*>(smem + Smem::BAR_OFF);
  bar.xempty = bar.xfull + X_STAGES;
  bar.rfull = bar.xempty + X_STAGES;
  bar.rempty = bar.rfull + R_STAGES;

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int k_steps = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < X_STAGES; ++s) {
      mbar_init(bar.xfull + s, 1);
      mbar_init(bar.xempty + s, 8);  // one per consumer warp
    }
    for (int s = 0; s < R_STAGES; ++s) {
      mbar_init(bar.rfull + s, 1);
      mbar_init(bar.rempty + s, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 256) {
    consumer<BITS>(sX, sR, bar, scale, bias, y, M, N, ldy, n_tiles, tiles, k_steps,
                   threadIdx.x / 128);
  } else if (threadIdx.x == 256) {  // the producer: one thread issues every load
    prefetch_tensormap(&tx);
    prefetch_tensormap(&tw);
    int it = 0, jr = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        if (ks % F::STEPS_PER_RAW == 0) {
          const int rs = jr % R_STAGES;
          mbar_wait(bar.rempty + rs, ((jr / R_STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(bar.rfull + rs, Smem::R);
          tma_load_2d(sR + rs * Smem::R, &tw, bar.rfull + rs, ks * F::STEP_BYTES, n0);
          ++jr;
        }
        const int xs = it % X_STAGES;
        mbar_wait(bar.xempty + xs, ((it / X_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar.xfull + xs, Smem::X);
        tma_load_2d(sX + xs * Smem::X, &tx, bar.xfull + xs, ks * BK, m0);
      }
    }
  }
}

// A [rows][inner] matrix with a row stride of `stride` bytes as a 2-d tensor
// map, boxes of [box_rows][box_inner] in the 128-byte swizzle; elements
// beyond the extents read as 0
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long inner,
              long long rows, long long stride, int box_inner, int box_rows) {
  const PFN_cuTensorMapEncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows)};
  cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int BITS>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* y, int M,
           int N, int K, long long ldx, long long ldw, long long ldy, void* stream) {
  const long long w_bytes = BITS == INT8 ? K : (K + 1) / 2;
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < w_bytes || ldy < N)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  // what TMA cannot describe: a base or a row stride off 16 bytes
  if (!make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, ldx * 2, BK, BM) ||
      !make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, w_bytes, N, ldw, RAW_BYTES, BN))
    return static_cast<int>(cudaErrorInvalidPitchValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = weight_only_gemm_kernel<BITS>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, ldy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm

}  // namespace

extern "C" {

// Every entry returns 0 on success, else the cudaError_t of the failed
// launch. Dtypes, shapes and devices are checked by the Python wrappers. ldx
// and ldy are row strides in elements, ldw in bytes; bias may be null.

// The unaligned form: any pointers and strides.
int aigv_weight_only_int8_matmul(const void* x, const void* w, const void* scale,
                                 const void* bias, void* y, int M, int N, int K, long long ldx,
                                 long long ldw, long long ldy, void* stream) {
  return unaligned::launch<INT8>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

int aigv_weight_only_int4_matmul(const void* x, const void* w, const void* scale,
                                 const void* bias, void* y, int M, int N, int K, long long ldx,
                                 long long ldw, long long ldy, void* stream) {
  return unaligned::launch<INT4>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

// The GEMM form: x and w with 16-byte aligned bases and row strides (else
// cudaErrorInvalidPitchValue).
int aigv_weight_only_int8_gemm(const void* x, const void* w, const void* scale, const void* bias,
                               void* y, int M, int N, int K, long long ldx, long long ldw,
                               long long ldy, void* stream) {
  return gemm::launch<INT8>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

int aigv_weight_only_int4_gemm(const void* x, const void* w, const void* scale, const void* bias,
                               void* y, int M, int N, int K, long long ldx, long long ldw,
                               long long ldy, void* stream) {
  return gemm::launch<INT4>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

// The GEMV form: any M (blocks of 8 rows), any pointers and strides.
int aigv_weight_only_int8_gemv(const void* x, const void* w, const void* scale, const void* bias,
                               void* y, int M, int N, int K, long long ldx, long long ldw,
                               long long ldy, void* stream) {
  return decode_matvec::launch<Int8Weights>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

int aigv_weight_only_int4_gemv(const void* x, const void* w, const void* scale, const void* bias,
                               void* y, int M, int N, int K, long long ldx, long long ldw,
                               long long ldy, void* stream) {
  return decode_matvec::launch<Int4Weights>(x, w, scale, bias, y, M, N, K, ldx, ldw, ldy, stream);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
