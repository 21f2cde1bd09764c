// One fused value stage of the int8 net: a program of op descriptors run
// over the stage's values in shared memory, one block per frame.
//
// Replaces yoloface_tpu/kernels/pallas_fused.py::build_fused_plan (the
// stage kernel of its pallas_call, over the ops of lower_fused_ops): the
// fused conv+leaky pairs in fast (v1) and exact bits, PAD as a value or
// absorbed into a conv window, the separable MAX_POOL, ADD, QUANTIZE,
// standalone LEAKY_RELU, RELU, RELU6, LOGISTIC, RESIZE_NEAREST_NEIGHBOR and
// N-ary CONCATENATION.  The host planner is kernels/fused.py, its plain
// version the arena's executor (kernels/arena.py); the op bodies and the Op
// layout are in arena_ops.cuh.
//
// It also runs the per-op programs of kernels/perop.py, one op a launch
// with every view in device memory and only the max-pool scratch in shared
// memory, and so replaces four of the eleven per-op kernels of
// yoloface_tpu/kernels/pallas_int8.py as well: conv1x1, dwconv3x3 and
// conv3x3 (stride 1 and 2; the window reads strided taps where JAX reads
// the polyphase inputs of phase_split) and maxpool_int8 (eltwise_int8,
// leaky_int8 and requantize_int8 run on eltwise_lut.cu, a flat map over a
// tensor's bytes; add_int8 on add_int8.cu; resize_nearest, concat_channels
// and pad_int8 on the byte-move kernels of the same names, a resize or
// concat past their 16,384 channels here).
// There each op's input and output make a round trip through
// device memory (about 196 KB a 56x56 frame over the corpus net's 38
// tensors).
//
// What bounds it on the card: integer multiply-adds and max-pool compares
// on the CUDA cores (1.03 M MACs a 56x56 frame of the corpus net), not
// bytes: device memory moves only each stage's inputs and outputs.  What
// the design does about it, in this first version: the values of a stage
// (placed by liveness) stay in dynamic shared memory, external inputs come
// in and outputs go out with 16-byte moves.  The convs the planner marks
// (every CONV) run on the int8 tensor cores, the 3x3 depthwise convs four
// channels a thread, and the max-pools on 4-channel words as a row pass
// and a column pass through a scratch after the values (kw + kh compares
// a word instead of kh * kw a byte) (stage_ops.cuh, shared with the arena
// stage kernel).  Like the arena kernel it is built twice, a fast and an
// exact instantiation (stage_ops.cuh kExactEpis).
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"
#include "stage_ops.cuh"

namespace {

using yf::Globals;
using yf::Op;

// kExact: the exact instantiation (every body compiled with the exact
// epilogues, stage_ops.cuh kExactEpis), else the fast one (the fast sets).
template <bool kExact>
__global__ void __launch_bounds__(yf::kStageThreads, yf::kStageBlocks)
    fused_stage_kernel(const Op* __restrict__ ops, int n_ops,
                       const uint8_t* __restrict__ consts, Globals g,
                       int scratch_off) {
  constexpr unsigned kMma = kExact ? yf::kExactEpis : yf::kFusedMmaEpis;
  constexpr unsigned kConv = kExact ? yf::kExactEpis : yf::kFusedConvEpis;
  constexpr unsigned kDw = kExact ? yf::kExactEpis : yf::kFusedDwEpis;
  extern __shared__ __align__(16) int8_t smem[];
  const long long frame = blockIdx.x;
  for (int i = 0; i < n_ops; ++i) {
    const Op op = ops[i];
    const int8_t* in0 = yf::base(op.in0, smem, g, frame);
    int8_t* out = yf::base(op.out, smem, g, frame);
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
      case yf::MAXPOOL: {  // a per-op input staged first, then the scratch
        int8_t* scratch = smem + scratch_off;
        if (op.in0.space != 0) {
          in0 = yf::stage_view(op, in0, scratch);
          scratch += yf::staged_bytes(op.in0.h * op.in0.w * op.in0.cs);
        }
        yf::maxpool_words_op(op, in0, 0, out, 0, op.out.h,
                             reinterpret_cast<unsigned*>(scratch));
        break;
      }
      case yf::COPY:
        yf::copy_op(op, in0, out, op.out.h);
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
      default:           // ADD, QUANTIZE
        yf::eltwise_op(op, in0, yf::base(op.in1, smem, g, frame), out,
                       op.out.h);
    }
    __syncthreads();
  }
}

}  // namespace

// `exact`: launch the exact instantiation (kernels/arena.py
// Stage.exact_convs).
extern "C" int yf_fused_stage(const void* descs, int n_ops, const void* consts,
                              const void* host_ptrs, int n_globals,
                              int n_frames, int smem_bytes, int scratch_off,
                              int threads, int exact, void* stream) {
  if (n_globals > yf::kMaxGlobals)
    return static_cast<int>(cudaErrorInvalidValue);
  Globals g = {};
  const unsigned long long* p =
      static_cast<const unsigned long long*>(host_ptrs);
  for (int i = 0; i < n_globals; ++i)
    g.p[i] = reinterpret_cast<int8_t*>(p[i]);
  auto kernel = exact ? fused_stage_kernel<true> : fused_stage_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_frames, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Op*>(descs), n_ops,
      static_cast<const uint8_t*>(consts), g, scratch_off);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation `exact` as the build compiled it (yf_arena_stage_attrs'
// fields).
extern "C" int yf_fused_stage_attrs(int exact, int threads, int smem_bytes,
                                    int* out) {
  return yf::kernel_attrs(
      exact ? fused_stage_kernel<true> : fused_stage_kernel<false>, threads,
      smem_bytes, out);
}
