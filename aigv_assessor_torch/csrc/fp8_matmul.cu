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
// Design: the decode matvec of decode_matvec.cuh (its header has the whole
// account), which the weight-only matmuls' GEMV form shares: the operands
// swapped, so that one mma.sync m16n8k16 takes 16 output channels as its rows
// (the converted weight) and 8 rows of x as its columns; 8 warps per block
// split K, four 64-byte steps in flight each, with 16-byte loads straight into
// registers and no shared memory in the loop; the eight accumulators summed
// through shared memory. Here a weight byte is one e4m3 value: pairs of them
// go to f16 pairs by the hardware cvt (exact), then to fp32 and to a bf16 pair
// (exact), with lower K in the low half, as the shared body wants.

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

// Returns 0 on success, else the cudaError_t of the failed launch. Dtypes,
// shapes and devices are checked by the Python wrapper. ldx and ldy are row
// strides in elements, ldw in bytes.
int aigv_fp8_matmul(const void* x, const void* w, const void* scale, void* y, int M, int N,
                    int K, long long ldx, long long ldw, long long ldy, void* stream) {
  return decode_matvec::launch<E4M3>(x, w, scale, nullptr, y, M, N, K, ldx, ldw, ldy, stream);
}

const char* aigv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
