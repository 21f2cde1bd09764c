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
//
// The bodies after eltwise_op serve the fused stages (fused_stage.cu):
// copy_op (16-byte moves of dense views), pad_op, leaky_op, act_op
// (RELU / RELU6 clips, LOGISTIC), resize_op and the separable
// maxpool_sep_op, which needs a scratch of ((rows - 1) * sh + kh) * out.w *
// out.c bytes.  They take the same row origin and count as the bodies
// above, so the arena and tiled kernels can take them up unchanged.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace yf {

constexpr int kMaxGlobals = 16;
enum Code {
  COPY = 0, CONV = 1, DW = 2, MAXPOOL = 3, ADD = 4, QUANTIZE = 5,
  // the fused stages' ops (fused_stage.cu); no arena or tiled program
  // emits them yet
  PAD = 6, LEAKY = 7, ACT = 8, RESIZE = 9
};
enum Act { ACT_CLIP = 0, ACT_LOGISTIC = 1 };   // ACT's epi
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

// COPY of `rows` rows: between two dense views (cs == c on both sides: a
// stage input staged in, a stage output written out) 16 bytes a thread
// where both ends are 16-byte aligned; into a channel slice (a concat
// input) element by element.  `a` and `out` point at the same first row.
static __device__ void copy_op(const Op& op, const int8_t* a, int8_t* out,
                               int rows) {
  const int c_n = op.out.c;
  const int total = rows * op.out.w * c_n;
  if (op.in0.cs != c_n || op.out.cs != c_n) {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int c = e % c_n, p = e / c_n;
      out[p * op.out.cs + c] = a[p * op.in0.cs + c];
    }
    return;
  }
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0) {
    head = total / 16 * 16;
    const int4* src = reinterpret_cast<const int4*>(a);
    int4* dst = reinterpret_cast<int4*>(out);
    for (int i = threadIdx.x; i < total / 16; i += blockDim.x) dst[i] = src[i];
  }
  for (int i = head + threadIdx.x; i < total; i += blockDim.x) out[i] = a[i];
}

// PAD over output rows [oy0, oy0 + rows): element (y, x, c) is the input's
// (y - pt, x - pl, c) inside the input image and the fill outside it.
static __device__ void pad_op(const Op& op, const int8_t* in, int in_y0,
                              int8_t* out, int oy0, int rows) {
  const int c_n = op.out.c;
  const int total = rows * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int iy = oy0 + p / op.out.w - op.pt, ix = p % op.out.w - op.pl;
    const bool inb = iy >= 0 && iy < op.in0.h && ix >= 0 && ix < op.in0.w;
    out[p * op.out.cs + c] =
        inb ? in[((iy - in_y0) * op.in0.w + ix) * op.in0.cs + c]
            : static_cast<int8_t>(op.fill);
  }
}

// standalone LEAKY_RELU on v = x - zp_a: the v1 (fast) or exact leaky of
// epilogue.cuh; `a` and `out` point at the same first row.
static __device__ void leaky_op(const Op& op, const int8_t* a, int8_t* out,
                                int rows) {
  const int c_n = op.out.c;
  const int total = rows * op.out.w * c_n;
  const bool exact = op.epi == EPI_REQUANT_EXACT;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n, p = e / c_n;
    const int v = a[p * op.in0.cs + c] - op.zp_a;
    out[p * op.out.cs + c] =
        exact ? leaky_exact(v, op.m0, op.e0, op.m1, op.e1, op.zp_out)
              : leaky_v1(v, op.f0, op.f1, op.zp_out);
  }
}

// RELU / RELU6 (a clip to [zp_a, zp_b]) or LOGISTIC of (x - zp_a) * f0.
static __device__ void act_op(const Op& op, const int8_t* a, int8_t* out,
                              int rows) {
  const int c_n = op.out.c;
  const int total = rows * op.out.w * c_n;
  const bool sigmoid = op.epi == ACT_LOGISTIC;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n, p = e / c_n;
    const int x = a[p * op.in0.cs + c];
    out[p * op.out.cs + c] =
        sigmoid ? logistic(x - op.zp_a, op.f0)
                : static_cast<int8_t>(min(max(x, op.zp_a), op.zp_b));
  }
}

// RESIZE_NEAREST_NEIGHBOR by the integer factors kh x kw over output rows
// [oy0, oy0 + rows): element (y, x, c) is the input's (y / kh, x / kw, c).
static __device__ void resize_op(const Op& op, const int8_t* in, int in_y0,
                                 int8_t* out, int oy0, int rows) {
  const int c_n = op.out.c;
  const int total = rows * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int iy = (oy0 + p / op.out.w) / op.kh, ix = (p % op.out.w) / op.kw;
    out[p * op.out.cs + c] = in[((iy - in_y0) * op.in0.w + ix) * op.in0.cs + c];
  }
}

// separable max-pool over output rows [oy0, oy0 + rows): a row pass takes
// the max over the kw taps of each of the (rows - 1) * sh + kh padded input
// rows the windows read, at the output's columns, into `scratch`; a column
// pass takes the max over kh of those rows.  Taps outside the image read
// the fill, so the bits are the full window's max at kw + kh compares an
// output instead of kh * kw.  All threads of the block take part.
static __device__ void maxpool_sep_op(const Op& op, const int8_t* in,
                                      int in_y0, int8_t* out, int oy0,
                                      int rows, int8_t* scratch) {
  const int c_n = op.out.c, ow = op.out.w;
  const int r0 = oy0 * op.sh - op.pt;
  const int n_rows = (rows - 1) * op.sh + op.kh;
  const int fill = max(op.fill, -128);
  for (int e = threadIdx.x; e < n_rows * ow * c_n; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int iy = r0 + p / ow, ox = p % ow;
    int m = fill;
    if (iy >= 0 && iy < op.in0.h) {
      const int8_t* row = in + (iy - in_y0) * op.in0.w * op.in0.cs + c;
      m = -128;
      for (int dx = 0; dx < op.kw; ++dx) {
        const int ix = ox * op.sw - op.pl + dx;
        m = max(m, ix >= 0 && ix < op.in0.w ? row[ix * op.in0.cs] : op.fill);
      }
    }
    scratch[e] = static_cast<int8_t>(m);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * ow * c_n; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int8_t* col = scratch + ((p / ow) * op.sh * ow + p % ow) * c_n + c;
    int m = -128;
    for (int dy = 0; dy < op.kh; ++dy) m = max(m, col[dy * ow * c_n]);
    out[p * op.out.cs + c] = static_cast<int8_t>(m);
  }
}

}  // namespace yf
