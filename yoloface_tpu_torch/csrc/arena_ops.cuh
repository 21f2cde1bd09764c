// Device op bodies of the int8 net's descriptor programs, shared by the
// whole-frame arena stage (arena_stage.cu), the tiled section
// (tiled_section.cu) and the fused stage (fused_stage.cu, which also runs
// the per-op programs, every view in device memory).
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
// The bodies after eltwise_op came with the fused stages (fused_stage.cu):
// copy_op, pad_op, table_op (standalone LEAKY_RELU, RELU / RELU6 clips,
// LOGISTIC) and resize_op.  They take the same row origin and count as the
// bodies above, so the arena and tiled kernels run them too; avgpool_op
// runs in the arena and tiled kernels only.  The stage kernels (the
// whole-frame ones and, since its redesign, the section kernel) run their
// marked convs, their depthwise convs on word views and their max-pools
// with a scratch on the bodies of stage_ops.cuh, which take the same row
// origin and count.  Each kernel's switch traps on an op code it has no
// case for, so a code it lacks can never run as another op.
//
// The byte-bound bodies (copy_op, table_op, resize_op, avgpool_op) move 16
// bytes a thread where the views allow it: a dense view (cs == c) is one
// flat byte range, and a view whose channel count, channel stride and
// first byte are multiples of 16 is a row of 16-byte chunks, so one index
// computation serves 16 channels.  Elsewhere they keep the byte loop.
// table_op reads a 256-entry table of its op, built per op in static
// shared memory (kTableBytes, which the planners leave out of the arena
// budget) by table_value, the op's value functions of epilogue.cuh, so
// the bits are those functions' by construction.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace yf {

constexpr int kMaxGlobals = 16;
enum Code {
  COPY = 0, CONV = 1, DW = 2, MAXPOOL = 3, ADD = 4, QUANTIZE = 5,
  PAD = 6, LEAKY = 7, ACT = 8, RESIZE = 9,
  AVGPOOL = 10   // the arena and tiled programs only
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
  int frag_off;          // a marked 1x1 CONV's B fragments in consts, else 0
  int reserved[3];       // (the whole-frame kernels only: stage_ops.cuh)
};
static_assert(sizeof(Op) == 48 * 4, "Op must match kernels/arena.py FIELDS");

struct Globals {       // device pointers of the stage inputs then outputs
  int8_t* p[kMaxGlobals];
};

// static shared memory of table_op's table (kernels/arena.py TABLE_BYTES)
constexpr int kTableBytes = 256;

// the OR of the addresses, channel counts and strides a 16-byte (or
// 4-byte) chunk form needs aligned: its low bits must be clear
__device__ __forceinline__ uintptr_t addr(const void* p) {
  return reinterpret_cast<uintptr_t>(p);
}

// First held byte of a view: the arena's, or this frame's in device memory
// (64-bit: frame * frame bytes passes 2**31 at a few thousand 448 frames).
__device__ __forceinline__ int8_t* base(const View& v, int8_t* arena,
                                        const Globals& g, long long frame) {
  if (v.space == 0) return arena + v.offset;
  return g.p[v.space - 1] + frame * v.h * v.w * v.cs + v.offset;
}

// The int8 output of a conv's int32 accumulator `acc` (bias included) at
// output channel `co`, by the epilogue kEpi (the op's epi): fast requant,
// the fused leaky's v2 (fast2) or v1 (fast) form, exact requant or the
// exact fused leaky.  `scale` and `qms` are the op's constants (f32
// scale[C]; exact: int32 qm[C] then shift[C]).  A body that knows its
// op's epilogue at compile time (stage_ops.cuh) calls this form.
template <int kEpi>
__device__ __forceinline__ int8_t conv_epilogue_as(const Op& op, int acc,
                                                   int co, const float* scale,
                                                   const int* qms) {
  switch (kEpi) {
    case EPI_LEAKY_V2:
      return requant_leaky_v2(acc, __ldg(scale + co), op.conv_zp, op.f0,
                              op.f1, op.zp_out);
    case EPI_LEAKY_V1:
      return requant_leaky_v1(acc, __ldg(scale + co), op.conv_zp, op.f0,
                              op.f1, op.zp_out);
    case EPI_REQUANT_EXACT:
      return requant_exact(acc, __ldg(qms + co), __ldg(qms + op.out.c + co),
                           op.zp_out);
    case EPI_LEAKY_EXACT:
      return requant_leaky_exact(acc, __ldg(qms + co),
                                 __ldg(qms + op.out.c + co), op.conv_zp,
                                 op.m0, op.e0, op.m1, op.e1, op.zp_out);
    default:
      return requant_fast(acc, __ldg(scale + co), op.zp_out);
  }
}

// conv_epilogue_as by the op's epi at run time.  Every conv body stores
// through one of the two forms.
__device__ __forceinline__ int8_t conv_epilogue(const Op& op, int acc, int co,
                                                const float* scale,
                                                const int* qms) {
  switch (op.epi) {    // uniform across the block: no divergence
    case EPI_LEAKY_V2:
      return conv_epilogue_as<EPI_LEAKY_V2>(op, acc, co, scale, qms);
    case EPI_LEAKY_V1:
      return conv_epilogue_as<EPI_LEAKY_V1>(op, acc, co, scale, qms);
    case EPI_REQUANT_EXACT:
      return conv_epilogue_as<EPI_REQUANT_EXACT>(op, acc, co, scale, qms);
    case EPI_LEAKY_EXACT:
      return conv_epilogue_as<EPI_LEAKY_EXACT>(op, acc, co, scale, qms);
    default:
      return conv_epilogue_as<EPI_REQUANT>(op, acc, co, scale, qms);
  }
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
    out[p * op.out.cs + co] = conv_epilogue(op, acc, co, scale, qms);
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

// The mean of an average pool's window: `sum` of the raw int8 values of
// its `count` taps inside the image, rounding half away from zero in
// integer division: (sum +- count / 2) / count, clipped to int8.
__device__ __forceinline__ int pool_mean(int sum, int count) {
  const int half = count / 2;
  return clip_i8(sum >= 0 ? (sum + half) / count : -((half - sum) / count));
}

// AVERAGE_POOL_2D over output rows [oy0, oy0 + rows); `out` points at row
// oy0.  The sum of the raw int8 values of the taps inside the image (the
// zero fill adds nothing), divided by the count of those taps
// (pool_mean).  Where 16-byte chunks fit the views, a thread takes one
// (output pixel, 16 channels): the window's clipped bounds and tap count
// once, then one 16-byte read a tap.
static __device__ void avgpool_op(const Op& op, const int8_t* in, int in_y0,
                                  int8_t* out, int oy0, int rows) {
  const int c_n = op.out.c;
  if (((addr(in) | addr(out) | c_n | op.in0.cs | op.out.cs) & 15) == 0) {
    const int nq = c_n / 16;
    for (int e = threadIdx.x; e < rows * op.out.w * nq; e += blockDim.x) {
      const int q = e % nq, p = e / nq;
      const int ox = p % op.out.w, oy = oy0 + p / op.out.w;
      const int y0 = oy * op.sh - op.pt, x0 = ox * op.sw - op.pl;
      const int ya = max(y0, 0), yb = min(y0 + op.kh, op.in0.h);
      const int xa = max(x0, 0), xb = min(x0 + op.kw, op.in0.w);
      int sum[16] = {};
      for (int iy = ya; iy < yb; ++iy) {
        const uint4* row = reinterpret_cast<const uint4*>(
                               in + (iy - in_y0) * op.in0.w * op.in0.cs) + q;
        for (int ix = xa; ix < xb; ++ix) {
          const uint4 v = row[ix * (op.in0.cs / 16)];
          const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 16; ++k)
            sum[k] += static_cast<int8_t>(w[k / 4] >> (8 * (k % 4)));
        }
      }
      const int count = (yb - ya) * (xb - xa);
      unsigned o[4] = {};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        o[k / 4] |= static_cast<unsigned>(static_cast<uint8_t>(
                         pool_mean(sum[k], count))) << (8 * (k % 4));
      reinterpret_cast<uint4*>(out + p * op.out.cs)[q] =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    return;
  }
  const int total = rows * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int ox = p % op.out.w, oy = oy0 + p / op.out.w;
    int sum = 0, taps_h = 0, taps_w = 0;
    for (int dy = 0; dy < op.kh; ++dy) {
      const int iy = oy * op.sh - op.pt + dy;
      if (iy < 0 || iy >= op.in0.h) continue;
      ++taps_h;
      taps_w = 0;
      for (int dx = 0; dx < op.kw; ++dx) {
        const int ix = ox * op.sw - op.pl + dx;
        if (ix < 0 || ix >= op.in0.w) continue;
        ++taps_w;
        sum += in[((iy - in_y0) * op.in0.w + ix) * op.in0.cs + c];
      }
    }
    out[p * op.out.cs + c] =
        static_cast<int8_t>(pool_mean(sum, taps_h * taps_w));
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

// The elementwise maps of the byte-bound bodies, each on a 16-byte chunk,
// a 4-byte word and a byte: the identity (COPY) and a 256-entry table
// indexed by the byte (LEAKY, RELU, RELU6, LOGISTIC).
struct CopyFn {
  __device__ uint4 operator()(uint4 v) const { return v; }
  __device__ unsigned operator()(unsigned w) const { return w; }
  __device__ int8_t operator()(int8_t x) const { return x; }
};

struct TableFn {
  const int8_t* lut;
  __device__ int8_t operator()(int8_t x) const {
    return lut[static_cast<uint8_t>(x)];
  }
  __device__ unsigned operator()(unsigned w) const {
    unsigned r = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r |= static_cast<unsigned>(static_cast<uint8_t>(
               lut[(w >> (8 * k)) & 255])) << (8 * k);
    return r;
  }
  __device__ uint4 operator()(uint4 v) const {
    return make_uint4((*this)(v.x), (*this)(v.y), (*this)(v.z), (*this)(v.w));
  }
};

// dst[i] = f(src[i]) for i < n over one flat byte range, by threads t, t +
// stride, ...: 16 bytes a step with kInFlight independent loads issued
// before the first store (device-memory latency is hidden by bytes in
// flight), bytes where either end is not 16-byte aligned and for the tail.
constexpr int kInFlight = 4;

template <class Index, class F>
__device__ __forceinline__ void map_flat(const int8_t* src, int8_t* dst,
                                         Index n, F f, Index t,
                                         Index stride) {
  Index head = 0;
  if (((addr(src) | addr(dst)) & 15) == 0) {
    const Index n16 = n / 16;
    head = n16 * 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    Index i = t;
    for (; i + (kInFlight - 1) * stride < n16; i += kInFlight * stride) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) v[u] = s[i + u * stride];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) d[i + u * stride] = f(v[u]);
    }
    for (; i < n16; i += stride) d[i] = f(s[i]);
  }
  for (Index i = head + t; i < n; i += stride) dst[i] = f(src[i]);
}

// out = f(a) over `rows` rows of two views; `a` and `out` point at the
// same first row.  Two dense views (cs == c on both sides: a stage input
// staged in, a stage output written out, an op between dense tensors) are
// one flat byte range; views whose first bytes, channel count and strides
// are multiples of 16 (or 4) move a chunk of 16 (or 4) channels a thread
// step; others (a channel slice of a concat at an odd offset) a byte.
template <class T, class F>
static __device__ void map_chunks(const int8_t* a, int a_cs, int8_t* out,
                                  int out_cs, int pixels, int c_n, F f) {
  const int nq = c_n / static_cast<int>(sizeof(T));
  for (int e = threadIdx.x; e < pixels * nq; e += blockDim.x) {
    const int q = e % nq, p = e / nq;
    reinterpret_cast<T*>(out + p * out_cs)[q] =
        f(reinterpret_cast<const T*>(a + p * a_cs)[q]);
  }
}

template <class F>
static __device__ void map_op(const Op& op, const int8_t* a, int8_t* out,
                              int rows, F f) {
  const int c_n = op.out.c, pixels = rows * op.out.w;
  if (op.in0.cs == c_n && op.out.cs == c_n) {
    map_flat<int>(a, out, pixels * c_n, f, threadIdx.x, blockDim.x);
    return;
  }
  const uintptr_t bits = addr(a) | addr(out) | c_n | op.in0.cs | op.out.cs;
  if ((bits & 15) == 0) {
    map_chunks<uint4>(a, op.in0.cs, out, op.out.cs, pixels, c_n, f);
  } else if ((bits & 3) == 0) {
    map_chunks<unsigned>(a, op.in0.cs, out, op.out.cs, pixels, c_n, f);
  } else {
    for (int e = threadIdx.x; e < pixels * c_n; e += blockDim.x) {
      const int c = e % c_n, p = e / c_n;
      out[p * op.out.cs + c] = f(a[p * op.in0.cs + c]);
    }
  }
}

// COPY of `rows` rows (map_op's forms).
static __device__ void copy_op(const Op& op, const int8_t* a, int8_t* out,
                               int rows) {
  map_op(op, a, out, rows, CopyFn{});
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

// The value of a table op at int8 input x: standalone LEAKY_RELU on v = x
// - zp_a (the v1 fast or exact leaky of epilogue.cuh), RELU / RELU6 (a
// clip to [zp_a, zp_b]) or LOGISTIC of (x - zp_a) * f0.
__device__ __forceinline__ int8_t table_value(const Op& op, int x) {
  if (op.code == LEAKY) {
    const int v = x - op.zp_a;
    return op.epi == EPI_REQUANT_EXACT
               ? leaky_exact(v, op.m0, op.e0, op.m1, op.e1, op.zp_out)
               : leaky_v1(v, op.f0, op.f1, op.zp_out);
  }
  return op.epi == ACT_LOGISTIC
             ? logistic(x - op.zp_a, op.f0)
             : static_cast<int8_t>(min(max(x, op.zp_a), op.zp_b));
}

// Fill `lut` (kTableBytes of shared memory) with table_value at each byte,
// one entry a thread, and make it visible to the block.
__device__ __forceinline__ void build_table(const Op& op, int8_t* lut) {
  for (int u = threadIdx.x; u < kTableBytes; u += blockDim.x)
    lut[u] = table_value(op, static_cast<int8_t>(u));
  __syncthreads();
}

// LEAKY_RELU, RELU, RELU6 or LOGISTIC of `rows` rows through the op's
// table (map_op's forms); all threads of the block take part.
static __device__ void table_op(const Op& op, const int8_t* a, int8_t* out,
                                int rows) {
  __shared__ int8_t lut[kTableBytes];
  build_table(op, lut);
  map_op(op, a, out, rows, TableFn{lut});
}

// RESIZE_NEAREST_NEIGHBOR by the integer factors kh x kw over output rows
// [oy0, oy0 + rows): element (y, x, c) is the input's (y / kh, x / kw, c).
// Where 16-byte chunks fit the views, one (output pixel, 16 channels) a
// thread step.
static __device__ void resize_op(const Op& op, const int8_t* in, int in_y0,
                                 int8_t* out, int oy0, int rows) {
  const int c_n = op.out.c;
  if (((addr(in) | addr(out) | c_n | op.in0.cs | op.out.cs) & 15) == 0) {
    const int nq = c_n / 16, in_q = op.in0.cs / 16, out_q = op.out.cs / 16;
    const uint4* src = reinterpret_cast<const uint4*>(in);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (int e = threadIdx.x; e < rows * op.out.w * nq; e += blockDim.x) {
      const int q = e % nq, p = e / nq;
      const int iy = (oy0 + p / op.out.w) / op.kh, ix = (p % op.out.w) / op.kw;
      dst[p * out_q + q] = src[((iy - in_y0) * op.in0.w + ix) * in_q + q];
    }
    return;
  }
  const int total = rows * op.out.w * c_n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % c_n;
    const int p = e / c_n;
    const int iy = (oy0 + p / op.out.w) / op.kh, ix = (p % op.out.w) / op.kw;
    out[p * op.out.cs + c] = in[((iy - in_y0) * op.in0.w + ix) * op.in0.cs + c];
  }
}

}  // namespace yf
