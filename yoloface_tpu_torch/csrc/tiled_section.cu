// One tiled section of the int8 net: a program of op descriptors run over
// one strip of rows of one frame, the strip's part of every tensor in
// shared memory.
//
// Replaces yoloface_tpu/kernels/pallas_tiled.py::_build_tiled_section (the
// W-strip section kernel lowered by _lower_section), with the epilogues of
// pallas_int8.py::apply_requant_leaky inside it (epilogue.cuh,
// stage_ops.cuh): fast2, fast (v1) and exact bits.  The host planner and
// the plain version are in kernels/tiled.py.  It runs every op the arena
// stage runs, in strips: RELU / RELU6 / LOGISTIC (pallas_tiled.py:944) and
// standalone LEAKY_RELU (:959) row by row, RESIZE_NEAREST_NEIGHBOR through
// its own row origin (output row y reads input row y / kh),
// AVERAGE_POOL_2D and PAD as windows.  An op code with no case traps, which
// fails the launch, and so does a CONV the planner left unmarked.  COPY (a
// section's band copies in and out, and the copies into a concat's channel
// slices) runs arena_ops.cuh's copy_op, 16 bytes a thread step where the
// views allow.
//
// The op bodies are the whole-frame kernels' (stage_ops.cuh), each called
// with a strip's rows (conv_op's contract), as the TPU kernel runs "1x1
// convs and im2col k x k convs as per-(w,h) [Co,K]@[K,NT] MXU dots,
// depthwise as int32 VPU taps, pools separable" (pallas_tiled.py:29-32):
//  * every CONV on the int8 tensor cores (the planner marks them all,
//    kernels/tiled.py mark_mma): a 1x1 on conv1x1_mma_body, a full window
//    (the stems, ci = 3, K 27 -> 32) on conv_mma_body, with m16n8k16 B
//    fragments packed at plan time (the descriptor's frag_off); a big-K
//    conv the planner also marks for the k32 body (conv_mma.cuh, the
//    StripOp's mma_off) runs there in the k32 instantiations;
//  * a 3x3 depthwise conv on 4-channel words (dw3x3_words_op) where the
//    view allows, else byte by byte;
//  * a MAX_POOL as a row pass and a column pass on 4-channel words
//    (maxpool_words_op) through a scratch past the strip arena where the
//    planner gave one (scratch_off; kernels/tiled.py with_smem), else the
//    full window (maxpool_op).
//
// The kernel is a template on its bit family, as the whole-frame kernels
// are: the fast instantiation compiles the fast epilogues (stage_ops.cuh
// kFastEpis) into every body, the exact one kExactEpis, with the fused
// exact leaky from the op's 256-entry table (conv_table) and one mbqm32
// an element; neither compiles a run-time epilogue choice, and an
// epilogue outside its set traps.  The host picks the instantiation by
// the program (kernels/arena.py Stage.exact_convs).  Each has a k32 twin for sections
// holding a big-K conv marked for conv_mma_op, bound to fewer blocks an SM
// (kK32Blocks).
// Each of the four has a traced twin, launched only while a
// torch.profiler session records, that sums each descriptor's cycles into
// a counter (stage_ops.cuh OpCycles; runtime/profiler.py stage_cycles).
//
// What bounds it on the card: the operations of the bodies above (the
// tensor cores' MACs, and the depthwise taps and max-pool compares on the
// CUDA cores), recomputed halo rows included, and their shared-memory
// reads.  A section's inputs and outputs go through device memory, 0.2-1 MB
// a frame each.  The layout:
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
//    the image in the bodies), so edge strips need no fills of their own;
//  * the planner picks the strip height so the strip arena fits a third
//    of the 227 KB a block may have (kSectionBlocks blocks an SM), and cuts
//    sections where the halo recompute would pass 10%.
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"
#include "conv_mma.cuh"
#include "stage_ops.cuh"

namespace {

using yf::Globals;
using yf::Op;
using yf::View;

struct Band {          // strip j holds image rows [j*m - a, j*m - a + rows)
  int m, a, rows;
};

struct StripOp {       // 64 int32: arena.py FIELDS, BAND_FIELDS, MMA_FIELD
  Op op;
  Band in0, in1, out;
  int mma_off;         // a big-K CONV's k32 B fragments in consts, else 0
  int reserved[6];
};
static_assert(sizeof(StripOp) == 64 * 4,
              "StripOp must match kernels/arena.py STRIP_OP_INTS");

// First image row a view holds: device memory holds the whole image.
__device__ __forceinline__ int origin(const View& v, const Band& b, int j) {
  return v.space == 0 ? j * b.m - b.a : 0;
}

// The blocks an SM the launch bounds ask for (tools/torch_variant_sweep.py
// mma_body; PERF.md section 6): the fast and exact instantiations spill at
// 4 (64 registers: the strip bookkeeping on top of the whole-frame bodies)
// and take 77 registers and none at 3 (3 ran the 448 net in 3.3% less
// time than 4 and 9.1% less than 2); the k32 ones spill at 4 or 3
// (conv_mma_op's accumulators for kMmaNt n8 tiles) and take up to 127
// registers and none at 2.
constexpr int kSectionBlocks = 3;
constexpr int kK32Blocks = 2;

// kExact: the exact instantiation (kExactEpis in every body), else the
// fast one (kFastEpis).  kK32: big-K convs marked for conv_mma_op run
// there.  kTrace: the traced twin, which sums each op's cycles into
// op_cycles (stage_ops.cuh OpCycles); the untraced one never reads it.
template <bool kExact, bool kK32, bool kTrace>
__global__ void __launch_bounds__(yf::kStageThreads,
                                  kK32 ? kK32Blocks : kSectionBlocks)
    tiled_section_kernel(const StripOp* __restrict__ ops, int n_ops,
                         const uint8_t* __restrict__ consts, Globals g,
                         int strips, int scratch_off,
                         unsigned long long* op_cycles) {
  constexpr unsigned kEpis = kExact ? yf::kExactEpis : yf::kFastEpis;
  constexpr unsigned kTabled = kEpis & yf::kTableEpis;
  extern __shared__ __align__(16) int8_t arena[];
  const long long frame = blockIdx.x / strips;
  const int j = blockIdx.x % strips;
  yf::OpCycles<kTrace> cycles(op_cycles);
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
        case yf::CONV:   // every CONV is marked (kernels/tiled.py)
          if constexpr (kK32) {
            if (s.mma_off != 0) {
              yf::conv_table<kTabled>(op);
              yf::by_epilogue<kEpis, true>(
                  op.epi, yf::ConvK32{op, in0, in0_y0, out, lo, hi - lo,
                                      consts, s.mma_off});
              break;
            }
          }
          if (op.frag_off == 0)
            __trap();    // an unmarked CONV: no body of this kernel runs it
          yf::conv_table<kTabled>(op);
          yf::marked_conv_op<kEpis, kEpis, true>(op, in0, in0_y0, out, lo,
                                                 hi - lo, consts);
          break;
        case yf::DW:
          yf::conv_table<kTabled>(op);
          yf::dw_op<kEpis, true>(op, in0, in0_y0, out, lo, hi - lo, consts);
          break;
        case yf::MAXPOOL:  // no scratch planned: the full-window body
          if (scratch_off != 0)
            yf::maxpool_words_op(
                op, in0, in0_y0, out, lo, hi - lo,
                reinterpret_cast<unsigned*>(arena + scratch_off));
          else
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
        case yf::ACT:
          yf::stage_table_op(op, in0_rows, out, hi - lo);
          break;
        case yf::COPY:
          yf::copy_op(op, in0_rows, out, hi - lo);
          break;
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
    cycles.after(i);
  }
}

using Kernel = void (*)(const StripOp*, int, const uint8_t*, Globals, int,
                        int, unsigned long long*);

template <bool kTrace>
Kernel instantiation(int exact, int k32) {
  if (exact)
    return k32 ? tiled_section_kernel<true, true, kTrace>
               : tiled_section_kernel<true, false, kTrace>;
  return k32 ? tiled_section_kernel<false, true, kTrace>
             : tiled_section_kernel<false, false, kTrace>;
}

Kernel instantiation(int exact, int k32, int trace) {
  return trace ? instantiation<true>(exact, k32)
               : instantiation<false>(exact, k32);
}

}  // namespace

// `smem_bytes` of dynamic shared memory a block: the strip arena, then from
// `scratch_off` the max-pools' scratch (kernels/tiled.py Section.smem_bytes,
// scratch_off; 0: no scratch, the max-pools take the full-window body).
// exact: the exact instantiation (Stage.exact_convs); k32: the one that
// runs big-K convs on conv_mma_op (Section.k32_convs).  op_cycles: null
// launches the untraced instantiation; else the traced one adds each
// descriptor's cycles to op_cycles[0..n_ops) (unsigned 64-bit sums).
extern "C" int yf_tiled_section(const void* descs, int n_ops,
                                const void* consts, const void* host_ptrs,
                                int n_globals, int n_frames, int strips,
                                int smem_bytes, int scratch_off, int threads,
                                int exact, int k32, void* op_cycles,
                                void* stream) {
  if (n_globals > yf::kMaxGlobals || strips < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Globals g = {};
  const unsigned long long* p =
      static_cast<const unsigned long long*>(host_ptrs);
  for (int i = 0; i < n_globals; ++i)
    g.p[i] = reinterpret_cast<int8_t*>(p[i]);
  const Kernel kernel = instantiation(exact, k32, op_cycles != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>(static_cast<long long>(n_frames) * strips);
  kernel<<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const StripOp*>(descs), n_ops,
      static_cast<const uint8_t*>(consts), g, strips, scratch_off,
      static_cast<unsigned long long*>(op_cycles));
  return static_cast<int>(cudaGetLastError());
}

// The instantiation (exact, k32, trace) as the build compiled it:
// registers a thread, local bytes a thread (its stack frame, spills
// included), static shared bytes, and the blocks of `threads` threads with
// `smem_bytes` of dynamic shared memory an SM holds at once, into
// out[0..3].
extern "C" int yf_tiled_section_attrs(int exact, int k32, int trace,
                                      int threads, int smem_bytes, int* out) {
  return yf::kernel_attrs(instantiation(exact, k32, trace), threads,
                          smem_bytes, out);
}
