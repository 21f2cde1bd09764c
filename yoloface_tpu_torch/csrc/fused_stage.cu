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
// memory, and so replaces the eleven per-op kernels of
// yoloface_tpu/kernels/pallas_int8.py as well: conv1x1, dwconv3x3 and
// conv3x3 (stride 1 and 2; the window reads strided taps where JAX reads
// the polyphase inputs of phase_split), pad_int8, maxpool_int8, add_int8,
// requantize_int8, concat_channels, eltwise_int8, resize_nearest and
// leaky_int8.  There each op's input and output make a round trip through
// device memory (about 196 KB a 56x56 frame over the corpus net's 38
// tensors).
//
// What bounds it on the card: integer multiply-adds and max-pool compares
// on the CUDA cores (1.03 M MACs a 56x56 frame of the corpus net), not
// bytes: device memory moves only each stage's inputs and outputs.  What
// the design does about it, in this first version: the values of a stage
// (placed by liveness) stay in dynamic shared memory, external inputs come
// in and outputs go out with 16-byte moves, and the max-pool runs as a row
// pass and a column pass through a scratch after the values (kw + kh
// compares an output instead of kh * kw).  Tensor cores for the 1x1 convs
// are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace {

using yf::Globals;
using yf::Op;

__global__ void fused_stage_kernel(const Op* __restrict__ ops, int n_ops,
                                   const uint8_t* __restrict__ consts,
                                   Globals g, int scratch_off) {
  extern __shared__ __align__(16) int8_t smem[];
  const long long frame = blockIdx.x;
  for (int i = 0; i < n_ops; ++i) {
    const Op op = ops[i];
    const int8_t* in0 = yf::base(op.in0, smem, g, frame);
    int8_t* out = yf::base(op.out, smem, g, frame);
    switch (op.code) {   // the whole frame: rows [0, out.h), held from 0
      case yf::CONV:
        yf::conv_op<false>(op, in0, 0, out, 0, op.out.h, consts);
        break;
      case yf::DW:
        yf::conv_op<true>(op, in0, 0, out, 0, op.out.h, consts);
        break;
      case yf::MAXPOOL:
        yf::maxpool_sep_op(op, in0, 0, out, 0, op.out.h, smem + scratch_off);
        break;
      case yf::COPY:
        yf::copy_op(op, in0, out, op.out.h);
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
      default:           // ADD, QUANTIZE
        yf::eltwise_op(op, in0, yf::base(op.in1, smem, g, frame), out,
                       op.out.h);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int yf_fused_stage(const void* descs, int n_ops, const void* consts,
                              const void* host_ptrs, int n_globals,
                              int n_frames, int smem_bytes, int scratch_off,
                              int threads, void* stream) {
  if (n_globals > yf::kMaxGlobals)
    return static_cast<int>(cudaErrorInvalidValue);
  Globals g = {};
  const unsigned long long* p =
      static_cast<const unsigned long long*>(host_ptrs);
  for (int i = 0; i < n_globals; ++i)
    g.p[i] = reinterpret_cast<int8_t*>(p[i]);
  cudaError_t err = cudaFuncSetAttribute(
      fused_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_stage_kernel<<<n_frames, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Op*>(descs), n_ops,
      static_cast<const uint8_t*>(consts), g, scratch_off);
  return static_cast<int>(cudaGetLastError());
}
