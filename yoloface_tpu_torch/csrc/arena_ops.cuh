// Device op bodies of the int8 net's descriptor programs, shared by the
// whole-frame arena stage (arena_stage.cu) and the tiled section
// (tiled_section.cu).
//
// The Op layout is kernels/arena.py's FIELDS tuple.  Each body computes a
// range of output rows of one op for one frame: `rows` rows from image row
// `oy0` on.  A window op's input pointer holds the input's image rows from
// `in_y0` on: the whole frame (in_y0 = 0) in the arena, a strip's band of
// rows in a tiled section.  Window reads are bounds-checked against the
// IMAGE (op.in0.h x op.in0.w), not the held rows, and return the op's fill
// value outside it (the PAD zero-point, the conv input zero-point, -128 for
// a SAME max-pool), so one body serves a frame and a strip, and no padded
// copies exist.  The planner guarantees that every in-image row a window
// reads is held.  The bodies have internal linkage: each kernel's
// translation unit compiles its own.
//
// Threads walk output elements with the channel fastest, so a pixel's
// input window is a shared-memory broadcast across the threads of
// neighbouring channels; weights come through the read-only cache.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace yf {

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

// First held byte of a view: the arena's, or this frame's in device memory
// (64-bit: frame * frame bytes passes 2**31 at a few thousand 448 frames).
__device__ __forceinline__ int8_t* base(const View& v, int8_t* arena,
                                        const Globals& g, long long frame) {
  if (v.space == 0) return arena + v.offset;
  return g.p[v.space - 1] + frame * v.h * v.w * v.cs + v.offset;
}

// conv (CONV: OHWI weights; DW: [1,kh,kw,c] weights) + epilogue over output
// rows [oy0, oy0 + rows); `out` points at output row oy0.
template <bool kDepthwise>
static __device__ void conv_op(const Op& op, const int8_t* in, int in_y0,
                               int8_t* out, int oy0, int rows,
                               const uint8_t* consts) {
  const int8_t* w = reinterpret_cast<const int8_t*>(consts + op.w_off);
  const int* bias = reinterpret_cast<const int*>(consts + op.b_off);
  const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
  const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
  const int co_n = op.out.c, ci_n = op.in0.c;
  const int total = rows * op.out.w * co_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int co = e % co_n;
    const int p = e / co_n;
    const int ox = p % op.out.w, oy = oy0 + p / op.out.w;
    int acc = __ldg(bias + co);
    for (int dy = 0; dy < op.kh; ++dy) {
      const int iy = oy * op.sh - op.pt + dy;
      const bool row_in = iy >= 0 && iy < op.in0.h;
      for (int dx = 0; dx < op.kw; ++dx) {
        const int ix = ox * op.sw - op.pl + dx;
        const bool inb = row_in && ix >= 0 && ix < op.in0.w;
        const int8_t* xp = in + ((iy - in_y0) * op.in0.w + ix) * op.in0.cs;
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
        r = requant_leaky_v2(acc, __ldg(scale + co), op.conv_zp, op.f0, op.f1,
                             op.zp_out);
        break;
      case EPI_LEAKY_V1:
        r = requant_leaky_v1(acc, __ldg(scale + co), op.conv_zp, op.f0, op.f1,
                             op.zp_out);
        break;
      case EPI_REQUANT_EXACT:
        r = requant_exact(acc, __ldg(qms + co), __ldg(qms + co_n + co),
                          op.zp_out);
        break;
      case EPI_LEAKY_EXACT:
        r = requant_leaky_exact(acc, __ldg(qms + co), __ldg(qms + co_n + co),
                                op.conv_zp, op.m0, op.e0, op.m1, op.e1,
                                op.zp_out);
        break;
      default:
        r = requant_fast(acc, __ldg(scale + co), op.zp_out);
    }
    out[p * op.out.cs + co] = r;
  }
}

// max-pool over output rows [oy0, oy0 + rows); `out` points at row oy0.
static __device__ void maxpool_op(const Op& op, const int8_t* in, int in_y0,
                                  int8_t* out, int oy0, int rows) {
  const int c_n = op.out.c;
  const int total = rows * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int ox = p % op.out.w, oy = oy0 + p / op.out.w;
    int m = -128;
    for (int dy = 0; dy < op.kh; ++dy) {
      const int iy = oy * op.sh - op.pt + dy;
      for (int dx = 0; dx < op.kw; ++dx) {
        const int ix = ox * op.sw - op.pl + dx;
        const bool inb = iy >= 0 && iy < op.in0.h && ix >= 0 && ix < op.in0.w;
        const int v =
            inb ? in[((iy - in_y0) * op.in0.w + ix) * op.in0.cs + c] : op.fill;
        m = max(m, v);
      }
    }
    out[p * op.out.cs + c] = static_cast<int8_t>(m);
  }
}

// elementwise ops over (pixel, channel) of `rows` rows: COPY, ADD,
// QUANTIZE; `a`, `b` and `out` point at the same first row.
static __device__ void eltwise_op(const Op& op, const int8_t* a,
                                  const int8_t* b, int8_t* out, int rows) {
  const int c_n = op.out.c;
  const int total = rows * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int va = a[p * op.in0.cs + c];
    const bool exact = op.epi == EPI_REQUANT_EXACT;
    int8_t r;
    switch (op.code) {
      case ADD: {
        const int vb = b[p * op.in1.cs + c] - op.zp_b;
        r = exact ? add_exact(va - op.zp_a, vb, op.lsh, op.m0, op.e0, op.m1,
                              op.e1, op.m2, op.e2, op.zp_out)
                  : add_fast(va - op.zp_a, vb, op.f0, op.f1, op.zp_out);
        break;
      }
      case QUANTIZE:
        r = exact ? requant_exact(va - op.zp_a, op.m0, op.e0, op.zp_out)
                  : quantize_fast(va - op.zp_a, op.f0, op.zp_out);
        break;
      default:
        r = static_cast<int8_t>(va);
    }
    out[p * op.out.cs + c] = r;
  }
}

}  // namespace yf
