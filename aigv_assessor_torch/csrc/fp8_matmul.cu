// fp8 (e4m3) weight-streaming matmul for decode, sm_90a: a few bf16 rows of
// activations against an e4m3 weight that is cast inside the kernel, never
// into device memory.
//
// Replaces the Pallas TPU kernel of benchmarks/fp8_decode_probe.py:
// `_fp8_kernel` (through `fp8_matmul`).
//
//   y[M, N] = bf16( (x[M, K] @ float(w[N, K])^T) * scale[N] )
//
//   x      bf16 [M, K], row stride ldx elements.
//   w      float8_e4m3fn, one row per output channel, row stride ldw bytes:
//          the probe's [K, N] leaf transposed, so that the K bytes of one
//          channel are contiguous.
//   scale  fp32 [N], applied to the fp32 sum; the result is rounded to bf16
//          once. Every e4m3 value is a bf16 value, so the cast is exact and
//          the products are those of the probe kernel.
//   M, N and K are any size: edges are predicated and zero-filled here, not
//   padded by the caller.
//
// What bounds it. At decode (M <= 8) each weight byte is used M times: the
// N * K weight bytes are nearly all the traffic, and the time is bounded by
// reading them once from device memory. Everything else serves that stream.
//
// Design: the decode matvecs of decode_matvec.cuh (its header has the whole
// account), in two forms that ops/fp8_matmul.fp8_form picks: the stream body
// (a persistent grid of streams, each warp copying its 64-byte weight steps
// into a ring in shared memory with cp.async, K split over 8 or 16 warps, the
// warps' sums merged in shared memory one item late), where the rows start on
// 16 bytes and the plan gives it more than one item a stream or 16 warps an
// item; else the tile body that the weight-only matmuls' GEMV form runs (a
// block of 8 warps a tile of 16 channels x 8 rows). Both swap the operands,
// so that one mma.sync m16n8k16 takes 16 output channels as its rows (the
// converted weight) and 8 rows of x as its columns. Here a weight byte is one
// e4m3 value: pairs of them go to f16 pairs by the hardware cvt (exact), then
// to fp32 and to a bf16 pair (exact), with lower K in the low half, as both
// bodies want. A bit-placement convert (the magnitude bits placed in a bf16
// word, times 2^120) was exact over every finite code but 4-8% slower on an
// H100: more instructions, and the convert does not bind.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_matvec.cuh"

namespace {

// two e4m3 bytes (low byte first) -> one register of two bf16, exactly
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t pair) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFF),
                                             __NV_E4M3));
  const float2 f = __half22float2(h);
  return pack_f32(f.x, f.y);
}

// the weight format of decode_matvec.cuh: one e4m3 value per byte
struct E4M3 {
  static constexpr int KPB = 1;
  static __device__ __forceinline__ void convert(uint32_t word, uint32_t (&pairs)[2]) {
    pairs[0] = e4m3x2_to_bf16x2(word);
    pairs[1] = e4m3x2_to_bf16x2(word >> 16);
  }
};

}  // namespace

extern "C" {

// Every entry returns 0 on success, else the cudaError_t of the failed
// launch. Dtypes, shapes and devices are checked by the Python wrapper
// (which picks the form: ops/fp8_matmul.fp8_form). ldx and ldy are row
// strides in elements, ldw in bytes.

// The stream body: x and w with 16-byte aligned bases and row strides.
int aigv_fp8_matmul_stream(const void* x, const void* w, const void* scale, void* y, int M,
                           int N, int K, long long ldx, long long ldw, long long ldy,
                           void* stream) {
  return decode_matvec::launch_stream<E4M3>(x, w, scale, nullptr, y, M, N, K, ldx, ldw, ldy,
                                            stream);
}

// The tile body: any pointers and strides.
int aigv_fp8_matmul_tiles(const void* x, const void* w, const void* scale, void* y, int M,
                          int N, int K, long long ldx, long long ldw, long long ldy,
                          void* stream) {
  return decode_matvec::launch_tiles<E4M3>(x, w, scale, nullptr, y, M, N, K, ldx, ldw, ldy,
                                           stream);
}

// The stream body's plan at (M, N, K) on the current device, into out: the
// warps that split an item's K (8 or 16), the streams, the items of a
// stream (per + 1 for the first `extra`, then per), the blocks. Returns 0,
// or the cudaError_t of reading the SM count.
int aigv_fp8_matmul_plan(int M, int N, int K, int* out) {
  const int sms = decode_matvec::sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const decode_matvec::Plan p = decode_matvec::plan(M, N, K, E4M3::KPB, sms);
  out[0] = p.split;
  out[1] = p.streams;
  out[2] = p.per;
  out[3] = p.extra;
  out[4] = p.blocks;
  return 0;
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
