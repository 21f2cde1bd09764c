// The per-op elementwise int8 kernel: RELU, RELU6, LOGISTIC, a standalone
// LEAKY_RELU or an int8 -> int8 QUANTIZE of a dense int8 tensor in device
// memory, as one map over its bytes.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::eltwise_int8 (the map of
// activation_int32 over int8 values), ::leaky_int8 (the standalone
// LEAKY_RELU of a conv output with more than one consumer, fast and exact
// bits) and ::requantize_int8 (fast and exact bits) for the per-op
// programs of kernels/perop.py whose kernel is one of those.  The wrapper
// and the plain version (the op's table built in torch from the per-value
// functions of ops/int8_ref.py and ops/int8_fast.py over the 256 int8
// values, then indexed) are in kernels/eltwise.py.
//
// What bounds it on the card: bytes.  Each input byte is read once and
// each output byte written once, two bytes an element at 3.35 TB/s; the
// op itself is one table lookup a byte.  What the design does about it:
//  * the per-op views are dense tensors (cs == c), so the op is one flat
//    map over N*H*W*C bytes, not a block a frame: a grid of the card's SM
//    count times the blocks an SM holds walks 16-byte chunks with a grid
//    stride, kInFlight independent 16-byte loads a thread before its first
//    store (yf::map_flat; some 3 MB in flight across the card cover a
//    microsecond of device-memory latency);
//  * the op's output depends on the input byte alone, so it is a 256-entry
//    int8 table in shared memory, built in each block's prologue, one entry
//    a thread, by flat_table_value: yf::table_value for an activation or a
//    LEAKY (leaky_v1 or leaky_exact of epilogue.cuh) and the QUANTIZE
//    epilogues of epilogue.cuh, the value functions the arena,
//    tiled and fused kernels run, so the bits are theirs by construction.
//    A byte costs one shared-memory read and no index arithmetic, in exact
//    bits too (the table's 256 MBQMs are made once a block).  QUANTIZE's
//    values are made here, not in yf::table_value, which the stage kernels
//    compile: a new case there would move their register allocation.
//    Byte-SIMD max/min for the clips was tried and gained nothing
//    measurable: the loads, not the lookups, set the time;
//  * a pointer that is not 16-byte aligned, or a tail that is not a
//    multiple of 16 bytes, takes the byte loop of the same kernel.
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace {

constexpr int kThreads = 256;

// The op of `op` at int8 input x: an activation or a LEAKY
// (yf::table_value) or an int8 -> int8 QUANTIZE of v = x - zp_a in fast or
// exact bits.
__device__ __forceinline__ int8_t flat_table_value(const yf::Op& op, int x) {
  if (op.code != yf::QUANTIZE) return yf::table_value(op, x);
  return op.epi == yf::EPI_REQUANT_EXACT
             ? yf::requant_exact(x - op.zp_a, op.m0, op.e0, op.zp_out)
             : yf::quantize_fast(x - op.zp_a, op.f0, op.zp_out);
}

__global__ void __launch_bounds__(kThreads)
    eltwise_lut_kernel(const yf::Op* __restrict__ desc,
                       const int8_t* __restrict__ x, int8_t* __restrict__ y,
                       long long n) {
  if (desc->code != yf::ACT && desc->code != yf::LEAKY &&
      desc->code != yf::QUANTIZE)
    __trap();
  __shared__ int8_t lut[yf::kTableBytes];
  for (int u = threadIdx.x; u < yf::kTableBytes; u += kThreads)
    lut[u] = flat_table_value(*desc, static_cast<int8_t>(u));
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  yf::map_flat(x, y, n, yf::TableFn{lut}, t,
               static_cast<long long>(gridDim.x) * kThreads);
}

}  // namespace

// y = the op of descriptor `desc` (one kernels/arena.py FIELDS row on the
// card: ACT, LEAKY or QUANTIZE; another op code traps) over the n bytes of x.
extern "C" int yf_eltwise_lut(const void* desc, const void* x, void* y,
                              long long n, void* stream) {
  static int blocks = 0;           // the card's SMs x the blocks an SM holds
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, eltwise_lut_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = sms * per_sm;
  }
  const long long want = (n / 16 + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 1 ? 1 : want < blocks ? want
                                                                 : blocks);
  eltwise_lut_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const yf::Op*>(desc), static_cast<const int8_t*>(x),
      static_cast<int8_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
