// One activation-arena stage of the int8 net: a program of op descriptors
// run over a per-frame arena in shared memory.
//
// Replaces yoloface_tpu/kernels/pallas_arena.py::_build_stage (the stage
// kernel planned by build_arena_plan over lower_arena_ops), with the
// epilogues of pallas_int8.py::apply_requant_leaky inside it (epilogue.cuh):
// one kernel for the fast2, fast (v1) and exact bit semantics, chosen per
// op by the descriptor's epilogue code.  The host planner and the plain
// version of this kernel are in kernels/arena.py; the Op layout below is
// its FIELDS tuple.
//
// What bounds it on the card: integer multiply-adds on the CUDA cores
// (1.03 M MACs a 56x56 frame) and shared-memory reads of the windows.
// Device memory moves only the 9,408 input bytes and 882 output bytes of a
// frame, because every intermediate tensor lives in the arena.
// What the design does about it, in this first version: one block per
// frame keeps the whole net in shared memory (23.5 KB for the corpus
// graph, so several blocks share an SM); threads walk output elements with
// the channel fastest, so a pixel's input window is a shared-memory
// broadcast across the threads of neighbouring channels; weights come
// through the read-only cache.  Window reads are bounds-checked and return
// the op's fill value, so no padded copies exist.  Tensor cores (int8
// mma/wgmma for the 1x1 convs) are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int kMaxGlobals = 16;
enum Code { COPY = 0, CONV = 1, DW = 2, MAXPOOL = 3, ADD = 4, QUANTIZE = 5 };
enum Epi {
  EPI_REQUANT = 0,        // fast requant (ADD/QUANTIZE: fast bits)
  EPI_LEAKY_V2 = 1,       // fast2 fused conv+leaky, one rounding
  EPI_LEAKY_V1 = 2,       // fast fused conv+leaky, two roundings
  EPI_REQUANT_EXACT = 3,  // exact requant (ADD/QUANTIZE: exact bits)
  EPI_LEAKY_EXACT = 4     // exact fused conv+leaky
};

struct View {          // element (y, x, c) at offset + (y * w + x) * cs + c
  int space, offset, h, w, c, cs;
};

struct Op {            // 48 int32, the host planner's FIELDS in order
  int code, epi;
  View in0, in1, out;
  int kh, kw, sh, sw, pt, pl, fill;
  int w_off, b_off, s_off;
  int zp_a, zp_b, zp_out, conv_zp;
  float f0, f1;
  int q_off;             // exact: int32 qm[C] then shift[C]
  int m0, e0, m1, e1, m2, e2;   // exact (qm, shift) pairs
  int lsh;               // exact ADD's left shift
  int reserved[4];
};
static_assert(sizeof(Op) == 48 * 4, "Op must match kernels/arena.py FIELDS");

struct Globals {       // device pointers of the stage inputs then outputs
  int8_t* p[kMaxGlobals];
};

__device__ __forceinline__ int8_t* base(const View& v, int8_t* arena,
                                        const Globals& g, long long frame) {
  if (v.space == 0) return arena + v.offset;
  return g.p[v.space - 1] + frame * v.h * v.w * v.cs + v.offset;
}

// conv (CONV: OHWI weights; DW: [1,kh,kw,c] weights) + epilogue
template <bool kDepthwise>
__device__ void conv_op(const Op& op, const int8_t* in, int8_t* out,
                        const uint8_t* consts) {
  const int8_t* w = reinterpret_cast<const int8_t*>(consts + op.w_off);
  const int* bias = reinterpret_cast<const int*>(consts + op.b_off);
  const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
  const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
  const int co_n = op.out.c, ci_n = op.in0.c;
  const int total = op.out.h * op.out.w * co_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int co = e % co_n;
    const int p = e / co_n;
    const int ox = p % op.out.w, oy = p / op.out.w;
    int acc = __ldg(bias + co);
    for (int dy = 0; dy < op.kh; ++dy) {
      const int iy = oy * op.sh - op.pt + dy;
      const bool row_in = iy >= 0 && iy < op.in0.h;
      for (int dx = 0; dx < op.kw; ++dx) {
        const int ix = ox * op.sw - op.pl + dx;
        const bool inb = row_in && ix >= 0 && ix < op.in0.w;
        const int8_t* xp = in + (iy * op.in0.w + ix) * op.in0.cs;
        if (kDepthwise) {
          const int xv = inb ? xp[co] : op.fill;
          acc += xv * __ldg(w + (dy * op.kw + dx) * co_n + co);
        } else {
          const int8_t* wp = w + ((co * op.kh + dy) * op.kw + dx) * ci_n;
          for (int ci = 0; ci < ci_n; ++ci) {
            const int xv = inb ? xp[ci] : op.fill;
            acc += xv * __ldg(wp + ci);
          }
        }
      }
    }
    int8_t r;
    switch (op.epi) {    // uniform across the block: no divergence
      case EPI_LEAKY_V2:
        r = yf::requant_leaky_v2(acc, __ldg(scale + co), op.conv_zp, op.f0,
                                 op.f1, op.zp_out);
        break;
      case EPI_LEAKY_V1:
        r = yf::requant_leaky_v1(acc, __ldg(scale + co), op.conv_zp, op.f0,
                                 op.f1, op.zp_out);
        break;
      case EPI_REQUANT_EXACT:
        r = yf::requant_exact(acc, __ldg(qms + co), __ldg(qms + co_n + co),
                              op.zp_out);
        break;
      case EPI_LEAKY_EXACT:
        r = yf::requant_leaky_exact(acc, __ldg(qms + co),
                                    __ldg(qms + co_n + co), op.conv_zp, op.m0,
                                    op.e0, op.m1, op.e1, op.zp_out);
        break;
      default:
        r = yf::requant_fast(acc, __ldg(scale + co), op.zp_out);
    }
    out[p * op.out.cs + co] = r;
  }
}

__device__ void maxpool_op(const Op& op, const int8_t* in, int8_t* out) {
  const int c_n = op.out.c;
  const int total = op.out.h * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int ox = p % op.out.w, oy = p / op.out.w;
    int m = -128;
    for (int dy = 0; dy < op.kh; ++dy) {
      const int iy = oy * op.sh - op.pt + dy;
      for (int dx = 0; dx < op.kw; ++dx) {
        const int ix = ox * op.sw - op.pl + dx;
        const bool inb = iy >= 0 && iy < op.in0.h && ix >= 0 && ix < op.in0.w;
        const int v =
            inb ? in[(iy * op.in0.w + ix) * op.in0.cs + c] : op.fill;
        m = max(m, v);
      }
    }
    out[p * op.out.cs + c] = static_cast<int8_t>(m);
  }
}

// elementwise ops over (pixel, channel): COPY, ADD, QUANTIZE
__device__ void eltwise_op(const Op& op, const int8_t* a, const int8_t* b,
                           int8_t* out) {
  const int c_n = op.out.c;
  const int total = op.out.h * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int va = a[p * op.in0.cs + c];
    const bool exact = op.epi == EPI_REQUANT_EXACT;
    int8_t r;
    switch (op.code) {
      case ADD: {
        const int vb = b[p * op.in1.cs + c] - op.zp_b;
        r = exact ? yf::add_exact(va - op.zp_a, vb, op.lsh, op.m0, op.e0,
                                  op.m1, op.e1, op.m2, op.e2, op.zp_out)
                  : yf::add_fast(va - op.zp_a, vb, op.f0, op.f1, op.zp_out);
        break;
      }
      case QUANTIZE:
        r = exact ? yf::requant_exact(va - op.zp_a, op.m0, op.e0, op.zp_out)
                  : yf::quantize_fast(va - op.zp_a, op.f0, op.zp_out);
        break;
      default:
        r = static_cast<int8_t>(va);
    }
    out[p * op.out.cs + c] = r;
  }
}

__global__ void arena_stage_kernel(const Op* __restrict__ ops, int n_ops,
                                   const uint8_t* __restrict__ consts,
                                   Globals g) {
  extern __shared__ __align__(16) int8_t arena[];
  const long long frame = blockIdx.x;
  for (int i = 0; i < n_ops; ++i) {
    const Op op = ops[i];
    const int8_t* in0 = base(op.in0, arena, g, frame);
    int8_t* out = base(op.out, arena, g, frame);
    switch (op.code) {
      case CONV:
        conv_op<false>(op, in0, out, consts);
        break;
      case DW:
        conv_op<true>(op, in0, out, consts);
        break;
      case MAXPOOL:
        maxpool_op(op, in0, out);
        break;
      default:
        eltwise_op(op, in0, base(op.in1, arena, g, frame), out);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int yf_arena_stage(const void* descs, int n_ops, const void* consts,
                              const void* host_ptrs, int n_globals,
                              int n_frames, int arena_bytes, int threads,
                              void* stream) {
  if (n_globals > kMaxGlobals) return static_cast<int>(cudaErrorInvalidValue);
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
