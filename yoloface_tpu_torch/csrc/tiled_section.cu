// One tiled section of the int8 net: a program of op descriptors run over
// one strip of rows of one frame, the strip's part of every tensor in
// shared memory.
//
// Replaces yoloface_tpu/kernels/pallas_tiled.py::_build_tiled_section (the
// W-strip section kernel lowered by _lower_section), with the epilogues of
// pallas_int8.py::apply_requant_leaky inside it (epilogue.cuh): fast2, fast
// (v1) and exact bits, chosen per op by the descriptor's epilogue code.
// The host planner and the plain version are in kernels/tiled.py; the op
// bodies are arena_ops.cuh's, shared with the arena stage, and it runs
// every op the arena stage runs, in strips: RELU / RELU6 / LOGISTIC
// (pallas_tiled.py:944) and standalone LEAKY_RELU (:959) row by row,
// RESIZE_NEAREST_NEIGHBOR through its own row origin (output row y reads
// input row y / kh), AVERAGE_POOL_2D and PAD as windows.  An op code with
// no case traps, which fails the launch.
//
// What bounds it on the card: integer multiply-adds on the CUDA cores
// (65.9 M MACs a 448x448 frame, plus the halo rows a strip recomputes) and
// shared-memory reads of the windows.  A section's inputs and outputs go
// through device memory, 0.2-1 MB a frame each, which the MACs outweigh.
// What the design does about it, in this first version:
//  * NHWC rows, not the TPU's W-strips: a strip of rows of a frame is one
//    contiguous byte range of each tensor, so a section input's band (its
//    strip rows plus the halo the section's windows read) is one copy;
//  * one block per (frame, strip), frame-major, so neighbouring strips
//    that re-read a halo run close together in time and find it in L2;
//  * each descriptor carries a Band per view: strip j holds image rows
//    [j*m - a, j*m - a + rows) of an arena tensor; an op computes the rows
//    of its output's band that lie in the image, and writes a section
//    output's own rows [j*m, (j+1)*m) to device memory;
//  * reads outside the image return the op's fill (bounds checks against
//    the image in arena_ops.cuh), so edge strips need no fills of their
//    own, and one view per tensor serves a max-pool's -128 and a conv's
//    zero-point alike;
//  * the planner picks the strip height so the strip arena fits a quarter
//    of the 227 KB a block may have (four blocks an SM), and cuts
//    sections where the halo recompute would pass 10% of the work.
// Tensor cores and a separable max-pool are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace {

using yf::Globals;
using yf::Op;
using yf::View;

struct Band {          // strip j holds image rows [j*m - a, j*m - a + rows)
  int m, a, rows;
};

struct StripOp {       // 64 int32: arena.py FIELDS, then BAND_FIELDS
  Op op;
  Band in0, in1, out;
  int reserved[7];
};
static_assert(sizeof(StripOp) == 64 * 4,
              "StripOp must match kernels/arena.py STRIP_OP_INTS");

// First image row a view holds: device memory holds the whole image.
__device__ __forceinline__ int origin(const View& v, const Band& b, int j) {
  return v.space == 0 ? j * b.m - b.a : 0;
}

// Four 256-thread blocks an SM (the planner sizes strip arenas for a
// quarter of the shared memory) need at most 64 registers a thread: without
// the bound the op cases of B6b take the kernel to 71, three blocks an SM,
// and the 448 net runs about 11% slower (PERF.md section 6); with it, 64
// and no spills.
__global__ void __launch_bounds__(256, 4)
    tiled_section_kernel(const StripOp* __restrict__ ops, int n_ops,
                         const uint8_t* __restrict__ consts, Globals g,
                         int strips) {
  extern __shared__ __align__(16) int8_t arena[];
  const long long frame = blockIdx.x / strips;
  const int j = blockIdx.x % strips;
  for (int i = 0; i < n_ops; ++i) {
    const StripOp s = ops[i];
    const Op& op = s.op;
    const int y = j * s.out.m - s.out.a;
    const int lo = max(y, 0), hi = min(y + s.out.rows, op.out.h);
    if (lo < hi) {     // uniform across the block
      const int in0_y0 = origin(op.in0, s.in0, j);
      const int8_t* in0 = yf::base(op.in0, arena, g, frame);
      int8_t* out = yf::base(op.out, arena, g, frame) +
                    (lo - origin(op.out, s.out, j)) * op.out.w * op.out.cs;
      // the row-local ops read the same rows of in0 as they write
      const int8_t* in0_rows = in0 + (lo - in0_y0) * op.in0.w * op.in0.cs;
      switch (op.code) {
        case yf::CONV:
          yf::conv_op<false>(op, in0, in0_y0, out, lo, hi - lo, consts);
          break;
        case yf::DW:
          yf::conv_op<true>(op, in0, in0_y0, out, lo, hi - lo, consts);
          break;
        case yf::MAXPOOL:
          yf::maxpool_op(op, in0, in0_y0, out, lo, hi - lo);
          break;
        case yf::AVGPOOL:
          yf::avgpool_op(op, in0, in0_y0, out, lo, hi - lo);
          break;
        case yf::PAD:
          yf::pad_op(op, in0, in0_y0, out, lo, hi - lo);
          break;
        case yf::RESIZE:   // input rows lo / kh .. (hi - 1) / kh
          yf::resize_op(op, in0, in0_y0, out, lo, hi - lo);
          break;
        case yf::LEAKY:
          yf::leaky_op(op, in0_rows, out, hi - lo);
          break;
        case yf::ACT:
          yf::act_op(op, in0_rows, out, hi - lo);
          break;
        case yf::COPY:
        case yf::ADD:
        case yf::QUANTIZE: {
          const int8_t* in1 = yf::base(op.in1, arena, g, frame) +
                              (lo - origin(op.in1, s.in1, j)) * op.in1.w *
                                  op.in1.cs;
          yf::eltwise_op(op, in0_rows, in1, out, hi - lo);
          break;
        }
        default:         // an op code this kernel has no case for
          __trap();
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int yf_tiled_section(const void* descs, int n_ops,
                                const void* consts, const void* host_ptrs,
                                int n_globals, int n_frames, int strips,
                                int arena_bytes, int threads, void* stream) {
  if (n_globals > yf::kMaxGlobals || strips < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Globals g = {};
  const unsigned long long* p =
      static_cast<const unsigned long long*>(host_ptrs);
  for (int i = 0; i < n_globals; ++i)
    g.p[i] = reinterpret_cast<int8_t*>(p[i]);
  cudaFuncSetAttribute(tiled_section_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       arena_bytes);
  const unsigned int blocks =
      static_cast<unsigned int>(static_cast<long long>(n_frames) * strips);
  tiled_section_kernel<<<blocks, threads, arena_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const StripOp*>(descs), n_ops,
      static_cast<const uint8_t*>(consts), g, strips);
  return static_cast<int>(cudaGetLastError());
}
