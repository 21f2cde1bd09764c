// The per-op int8 ADD kernel: y = a + b of two dense int8 tensors of one
// shape in device memory, requantized to y's scale, as one map over their
// byte pairs.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::add_int8 (fast and exact
// bits) for the per-op programs of kernels/perop.py whose kernel is
// add_int8.  The wrapper and the plain version (ops/int8_fast.py's
// add_int8_fast or ops/int8_ref.py's add_int8 on the descriptor's fields)
// are kernels/eltwise.py's add_flat and add_flat_plain.
//
// What bounds it on the card: bytes.  Each input byte is read once and each
// output byte written once, three bytes an element at 3.35 TB/s; the op is
// a few integer and float operations an element.  What the design does
// about it:
//  * the per-op views are dense tensors of one shape (kernels/arena.py
//    refuses a broadcasting ADD), so the op is one flat map over N*H*W*C
//    byte pairs, not a block a frame: a grid of at most the card's SM count
//    times the blocks an SM holds, sized from the bytes, walks 16-byte
//    chunks of both inputs with a grid stride, kAddInFlight chunks of each
//    a thread loaded before its first store (the last round predicated, so
//    a small op has all its loads in flight at once);
//  * each input's term of the sum depends on its own byte alone, so each
//    is a 256-entry table of 4-byte terms in shared memory, built in each
//    block's prologue: fast bits, the float product (x - zp) * scale
//    rounded on its own (__fmul_rn, as yf::add_fast rounds it); exact bits,
//    the int32 yf::mbqm((x - zp) << lsh, m, e) of yf::add_exact.  A byte
//    pair costs two shared-memory reads, then yf::add_fast's sum and
//    rounding or yf::add_exact's requant of the sum (one 64-bit MBQM where
//    yf::add_exact makes three), so the bits are epilogue.cuh's by
//    construction;
//  * a pointer that is not 16-byte aligned, or a tail that is not a
//    multiple of 16 bytes, takes the byte loop of the same kernel.  The two
//    inputs may be one tensor (x + x); only the output is written.
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace {

constexpr int kThreads = 256;
// 16-byte chunks of each input a thread loads before its first store
// (chosen by tools/torch_variant_sweep.py add against 1, 4 and 8)
constexpr int kAddInFlight = 2;
constexpr int kTerms = 2 * yf::kTableBytes;   // a's table, then b's

// The ADD of byte pairs through the term tables `ta` (a's 256 entries,
// then b's; kExact: int32 terms, else float32 bits), then the requant of
// their sum.
template <bool kExact>
struct AddFn {
  const uint32_t* ta;
  int m2, e2, zp_out;

  // the output byte of input bytes ua, ub (0..255: the int8 values' bits)
  __device__ __forceinline__ int8_t byte(unsigned ua, unsigned ub) const {
    const uint32_t sa = ta[ua], sb = ta[yf::kTableBytes + ub];
    if (kExact)
      return yf::requant_exact(static_cast<int>(sa) + static_cast<int>(sb),
                               m2, e2, zp_out);
    return yf::round_zp_clip(__fadd_rn(__uint_as_float(sa),
                                       __uint_as_float(sb)), zp_out);
  }
  __device__ __forceinline__ unsigned word(unsigned wa, unsigned wb) const {
    unsigned r = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r |= static_cast<unsigned>(static_cast<uint8_t>(
               byte((wa >> (8 * k)) & 255, (wb >> (8 * k)) & 255)))
           << (8 * k);
    return r;
  }
  __device__ __forceinline__ uint4 chunk(uint4 a, uint4 b) const {
    return make_uint4(word(a.x, b.x), word(a.y, b.y), word(a.z, b.z),
                      word(a.w, b.w));
  }
};

// y[i] = f(a[i], b[i]) for i < n by threads t, t + stride, ...: 16-byte
// chunks where a, b and y are all 16-byte aligned, kAddInFlight of each
// input loaded before the first store, the last round predicated; bytes
// for the tail and throughout where a pointer is not aligned.
template <class Fn>
__device__ __forceinline__ void add_walk(const int8_t* a, const int8_t* b,
                                         int8_t* y, long long n, Fn f,
                                         long long t, long long stride) {
  long long head = 0;
  if (((yf::addr(a) | yf::addr(b) | yf::addr(y)) & 15) == 0) {
    const long long n16 = n / 16;
    head = n16 * 16;
    const uint4* a16 = reinterpret_cast<const uint4*>(a);
    const uint4* b16 = reinterpret_cast<const uint4*>(b);
    uint4* y16 = reinterpret_cast<uint4*>(y);
    for (long long i0 = t; i0 < n16; i0 += kAddInFlight * stride) {
      uint4 va[kAddInFlight], vb[kAddInFlight];
#pragma unroll
      for (int u = 0; u < kAddInFlight; ++u) {
        const long long i = i0 + u * stride;
        if (i < n16) {
          va[u] = a16[i];
          vb[u] = b16[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kAddInFlight; ++u) {
        const long long i = i0 + u * stride;
        if (i < n16) y16[i] = f.chunk(va[u], vb[u]);
      }
    }
  }
  for (long long i = head + t; i < n; i += stride)
    y[i] = f.byte(static_cast<uint8_t>(a[i]), static_cast<uint8_t>(b[i]));
}

__global__ void __launch_bounds__(kThreads)
    add_int8_kernel(const yf::Op* __restrict__ desc,
                    const int8_t* __restrict__ a,
                    const int8_t* __restrict__ b, int8_t* __restrict__ y,
                    long long n) {
  if (desc->code != yf::ADD) __trap();
  const yf::Op& op = *desc;
  const bool exact = op.epi == yf::EPI_REQUANT_EXACT;
  __shared__ uint32_t terms[kTerms];
  for (int u = threadIdx.x; u < kTerms; u += kThreads) {
    const bool second = u >= yf::kTableBytes;
    const int v = static_cast<int8_t>(u & 255) - (second ? op.zp_b : op.zp_a);
    terms[u] = exact ? static_cast<uint32_t>(yf::mbqm(
                           v * (1 << op.lsh), second ? op.m1 : op.m0,
                           second ? op.e1 : op.e0))
                     : __float_as_uint(__fmul_rn(static_cast<float>(v),
                                                 second ? op.f1 : op.f0));
  }
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (exact)
    add_walk(a, b, y, n, AddFn<true>{terms, op.m2, op.e2, op.zp_out}, t,
             stride);
  else
    add_walk(a, b, y, n, AddFn<false>{terms, 0, 0, op.zp_out}, t, stride);
}

}  // namespace

// y = a + b by the ADD descriptor `desc` (one kernels/arena.py FIELDS row
// on the card; another op code traps) over the n bytes of a and of b.
extern "C" int yf_add_int8(const void* desc, const void* a, const void* b,
                           void* y, long long n, void* stream) {
  static int blocks = 0;           // the card's SMs x the blocks an SM holds
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, add_int8_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = sms * per_sm;
  }
  const long long want = (n / 16 + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 1 ? 1 : want < blocks ? want
                                                                 : blocks);
  add_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const yf::Op*>(desc), static_cast<const int8_t*>(a),
      static_cast<const int8_t*>(b), static_cast<int8_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
