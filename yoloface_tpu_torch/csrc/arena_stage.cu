// One activation-arena stage of the int8 net: a program of op descriptors
// run over a per-frame arena in shared memory.
//
// Replaces yoloface_tpu/kernels/pallas_arena.py::_build_stage (the stage
// kernel planned by build_arena_plan over lower_arena_ops), with the
// epilogues of pallas_int8.py::apply_requant_leaky inside it (epilogue.cuh):
// one kernel for the fast2, fast (v1) and exact bit semantics, chosen per
// op by the descriptor's epilogue code.  The host planner and the plain
// version of this kernel are in kernels/arena.py; the op bodies and the Op
// layout (its FIELDS tuple) are in arena_ops.cuh, shared with the tiled
// section kernel.  Besides the conv, depthwise, max-pool, ADD, QUANTIZE
// and COPY ops of the corpus net it runs the rest of the stage kernel's
// emits: AVERAGE_POOL_2D (pallas_arena.py:612), RELU / RELU6 / LOGISTIC
// (:654), standalone LEAKY_RELU (:738), RESIZE_NEAREST_NEIGHBOR (:753),
// and a PAD that a SAME window would pad again.  An op code with no case
// traps, which fails the launch (the error shows at the next sync).
//
// What bounds it on the card: integer multiply-adds on the CUDA cores
// (1.03 M MACs a 56x56 frame) and shared-memory reads of the windows.
// Device memory moves only the 9,408 input bytes and 882 output bytes of a
// frame, because every intermediate tensor lives in the arena.
// What the design does about it, in this first version: one block per
// frame keeps the whole net in shared memory (23.5 KB for the corpus
// graph, so several blocks share an SM); each op body computes every row
// of its output (arena_ops.cuh).  Tensor cores (int8 mma/wgmma for the 1x1
// convs) are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace {

using yf::Globals;
using yf::Op;

__global__ void arena_stage_kernel(const Op* __restrict__ ops, int n_ops,
                                   const uint8_t* __restrict__ consts,
                                   Globals g) {
  extern __shared__ __align__(16) int8_t arena[];
  const long long frame = blockIdx.x;
  for (int i = 0; i < n_ops; ++i) {
    const Op op = ops[i];
    const int8_t* in0 = yf::base(op.in0, arena, g, frame);
    int8_t* out = yf::base(op.out, arena, g, frame);
    switch (op.code) {   // the whole frame: rows [0, out.h), held from 0
      case yf::CONV:
        yf::conv_op<false>(op, in0, 0, out, 0, op.out.h, consts);
        break;
      case yf::DW:
        yf::conv_op<true>(op, in0, 0, out, 0, op.out.h, consts);
        break;
      case yf::MAXPOOL:
        yf::maxpool_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::AVGPOOL:
        yf::avgpool_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::PAD:
        yf::pad_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::LEAKY:
        yf::leaky_op(op, in0, out, op.out.h);
        break;
      case yf::ACT:
        yf::act_op(op, in0, out, op.out.h);
        break;
      case yf::RESIZE:
        yf::resize_op(op, in0, 0, out, 0, op.out.h);
        break;
      case yf::COPY:
      case yf::ADD:
      case yf::QUANTIZE:
        yf::eltwise_op(op, in0, yf::base(op.in1, arena, g, frame), out,
                       op.out.h);
        break;
      default:           // an op code this kernel has no case for
        __trap();
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int yf_arena_stage(const void* descs, int n_ops, const void* consts,
                              const void* host_ptrs, int n_globals,
                              int n_frames, int arena_bytes, int threads,
                              void* stream) {
  if (n_globals > yf::kMaxGlobals)
    return static_cast<int>(cudaErrorInvalidValue);
  Globals g = {};
  const unsigned long long* p =
      static_cast<const unsigned long long*>(host_ptrs);
  for (int i = 0; i < n_globals; ++i)
    g.p[i] = reinterpret_cast<int8_t*>(p[i]);
  cudaFuncSetAttribute(arena_stage_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       arena_bytes);
  arena_stage_kernel<<<n_frames, threads, arena_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Op*>(descs), n_ops,
      static_cast<const uint8_t*>(consts), g);
  return static_cast<int>(cudaGetLastError());
}
