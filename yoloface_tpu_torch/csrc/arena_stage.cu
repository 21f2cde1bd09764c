// One activation-arena stage of the int8 net: a program of op descriptors
// run over a per-frame arena in shared memory.
//
// Replaces yoloface_tpu/kernels/pallas_arena.py::_build_stage (the stage
// kernel planned by build_arena_plan over lower_arena_ops), with the
// epilogues of pallas_int8.py::apply_requant_leaky inside it (epilogue.cuh,
// stage_ops.cuh): one kernel for the fast2, fast (v1) and exact bit
// semantics, chosen per op by the descriptor's epilogue code, built twice
// (a fast instantiation and an exact one, whose bodies know the exact
// epilogues; the host picks by the program).  The host planner and the plain
// version of this kernel are in kernels/arena.py; the op bodies and the Op
// layout (its FIELDS tuple) are in arena_ops.cuh, shared with the tiled
// section kernel.  Besides the conv, depthwise, max-pool, ADD, QUANTIZE
// and COPY ops of the corpus net it runs the rest of the stage kernel's
// emits: AVERAGE_POOL_2D (pallas_arena.py:612), RELU / RELU6 / LOGISTIC
// (:654), standalone LEAKY_RELU (:738), RESIZE_NEAREST_NEIGHBOR (:753),
// and a PAD that a SAME window would pad again.  An op code with no case
// traps, which fails the launch (the error shows at the next sync).
// Each instantiation has a traced twin, launched only while a
// torch.profiler session records, that sums each descriptor's cycles into
// a counter (stage_ops.cuh OpCycles; runtime/profiler.py stage_cycles).
//
// What bounds it on the card: integer multiply-adds on the CUDA cores
// (1.03 M MACs a 56x56 frame) and shared-memory reads of the windows.
// Device memory moves only the 9,408 input bytes and 882 output bytes of a
// frame, because every intermediate tensor lives in the arena.
// What the design does about it: one block per frame keeps the whole net
// in shared memory (23.5 KB for the corpus graph, so several blocks share
// an SM); each op body computes every row of its output (arena_ops.cuh).
// The convs the planner marks (every CONV: the 1x1s and the stem) run on
// the int8 tensor cores, the 3x3 depthwise convs four channels a thread
// and the max-pools on 4-channel words through a scratch past the arena
// (stage_ops.cuh, shared with the fused stage kernel).  A
// stage's inputs come in and its outputs go out through copy_op, 16 bytes
// a thread step with four loads in flight, since a one-op stage at a real
// size (26x26x128, 173 KB of arena: one block an SM) is bound by those
// moves.
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"
#include "stage_ops.cuh"

namespace {

using yf::Globals;
using yf::Op;

// kExact: the exact instantiation (every body compiled with the exact
// epilogues, stage_ops.cuh kExactEpis), else the fast one (the fast sets).
// kTrace: the traced twin, which sums each op's cycles into op_cycles
// (stage_ops.cuh OpCycles); the untraced one never reads op_cycles.
template <bool kExact, bool kTrace>
__global__ void __launch_bounds__(yf::kStageThreads, yf::kStageBlocks)
    arena_stage_kernel(const Op* __restrict__ ops, int n_ops,
                       const uint8_t* __restrict__ consts, Globals g,
                       int scratch_off, unsigned long long* op_cycles) {
  constexpr unsigned kMma = kExact ? yf::kExactEpis : yf::kArenaMmaEpis;
  constexpr unsigned kConv = kExact ? yf::kExactEpis : yf::kArenaConvEpis;
  constexpr unsigned kDw = kExact ? yf::kExactEpis : yf::kArenaDwEpis;
  extern __shared__ __align__(16) int8_t arena[];
  const long long frame = blockIdx.x;
  yf::OpCycles<kTrace> cycles(op_cycles);
  for (int i = 0; i < n_ops; ++i) {
    const Op op = ops[i];
    const int8_t* in0 = yf::base(op.in0, arena, g, frame);
    int8_t* out = yf::base(op.out, arena, g, frame);
    switch (op.code) {   // the whole frame: rows [0, out.h), held from 0
      case yf::CONV:     // a marked conv on the tensor cores
        if (op.frag_off != 0) {
          yf::conv_table<(kMma | kConv) & yf::kTableEpis>(op);
          yf::marked_conv_op<kMma, kConv, kExact>(op, in0, 0, out, 0,
                                                  op.out.h, consts);
        } else {
          yf::conv_op<false>(op, in0, 0, out, 0, op.out.h, consts);
        }
        break;
      case yf::DW:
        yf::conv_table<kDw & yf::kTableEpis>(op);
        yf::dw_op<kDw, kExact>(op, in0, 0, out, 0, op.out.h, consts);
        break;
      case yf::MAXPOOL:  // no room for the scratch: the full-window body
        if (scratch_off != 0)
          yf::maxpool_words_op(
              op, in0, 0, out, 0, op.out.h,
              reinterpret_cast<unsigned*>(arena + scratch_off));
        else
          yf::maxpool_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::AVGPOOL:
        yf::avgpool_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::PAD:
        yf::pad_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::LEAKY:
      case yf::ACT:
        yf::stage_table_op(op, in0, out, op.out.h);
        break;
      case yf::RESIZE:
        yf::resize_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::COPY:
        yf::copy_op(op, in0, out, op.out.h);
        break;
      case yf::ADD:
      case yf::QUANTIZE:
        yf::eltwise_op(op, in0, yf::base(op.in1, arena, g, frame), out,
                       op.out.h);
        break;
      default:           // an op code this kernel has no case for
        __trap();
    }
    __syncthreads();
    cycles.after(i);
  }
}

using Kernel = void (*)(const Op*, int, const uint8_t*, Globals, int,
                        unsigned long long*);

Kernel instantiation(int exact, int trace) {
  if (exact)
    return trace ? arena_stage_kernel<true, true>
                 : arena_stage_kernel<true, false>;
  return trace ? arena_stage_kernel<false, true>
               : arena_stage_kernel<false, false>;
}

}  // namespace

// `smem_bytes` of dynamic shared memory a block: the arena, then from
// `scratch_off` the max-pools' scratch (kernels/arena.py stage_smem; 0: no
// scratch, the max-pools take the full-window body).  `exact`: launch the
// exact instantiation (kernels/arena.py Stage.exact_convs).  `op_cycles`:
// null launches the untraced instantiation; else the traced one adds each
// descriptor's cycles to op_cycles[0..n_ops) (unsigned 64-bit sums).
extern "C" int yf_arena_stage(const void* descs, int n_ops, const void* consts,
                              const void* host_ptrs, int n_globals,
                              int n_frames, int smem_bytes, int scratch_off,
                              int threads, int exact, void* op_cycles,
                              void* stream) {
  if (n_globals > yf::kMaxGlobals)
    return static_cast<int>(cudaErrorInvalidValue);
  Globals g = {};
  const unsigned long long* p =
      static_cast<const unsigned long long*>(host_ptrs);
  for (int i = 0; i < n_globals; ++i)
    g.p[i] = reinterpret_cast<int8_t*>(p[i]);
  const Kernel kernel = instantiation(exact, op_cycles != nullptr);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes);
  kernel<<<n_frames, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Op*>(descs), n_ops,
      static_cast<const uint8_t*>(consts), g, scratch_off,
      static_cast<unsigned long long*>(op_cycles));
  return static_cast<int>(cudaGetLastError());
}

// The instantiation (exact, trace) as the build compiled it: registers a
// thread, local bytes a thread (its stack frame, spills included), static
// shared bytes, and the blocks of `threads` threads with `smem_bytes` of
// dynamic shared memory an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0..3].
extern "C" int yf_arena_stage_attrs(int exact, int trace, int threads,
                                    int smem_bytes, int* out) {
  return yf::kernel_attrs(instantiation(exact, trace), threads, smem_bytes,
                          out);
}
