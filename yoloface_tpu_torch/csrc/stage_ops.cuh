// The conv and max-pool bodies of the stage kernels: the whole-frame ones
// (arena_stage.cu and fused_stage.cu, which also runs the per-op programs)
// and, since the section kernel's redesign, the tiled section kernel
// (tiled_section.cu).  Each body takes conv_op's contract
// (arena_ops.cuh): `in` holds the input's image rows from `in_y0` on,
// `out` points at output row `oy0`, and the body computes `rows` rows; the
// whole-frame kernels call with (0, 0, out.h), the section kernel with a
// strip's rows.  Each body first moves `in` back to where image row 0
// would lie (rows before in_y0 are never read), so the image-row
// arithmetic below serves a frame and a strip alike.
//
// marked_conv_op: a CONV that the planners mark (kernels/arena.py
// mark_mma: every CONV of a whole-frame program, 1x1 or a full window) on
// the int8 tensor cores, replacing conv_op<false> for it.  The JAX stage
// kernel runs these convs on the MXU in its own body
// (yoloface_tpu/kernels/pallas_arena.py:358, :384; the stem as im2col with
// one int8 dot an output position, :398-440).  An implicit GEMM:
//  * M: the output pixels of the rows computed (784, 196 or 49 in the
//    corpus net's frames; a strip's rows x out.w in a section), in m16
//    tiles; the last is ragged, its rows past the end read 0 and are not
//    stored;
//  * N: the output channels (4 to 40), in n8 tiles; the last is masked on
//    store;
//  * K: kh * kw * ci in (dy, dx, c) order (ci = 4 to 48 for the 1x1s, 27
//    for the stem), in k16 steps of
//    mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32.
// A warp item is one m16 tile by one n8 tile.
// A fragments: lane (g, t) holds K positions 4t..4t+3 of pixel g (and g +
// 8) of its k16 step.  The 1x1 body (conv1x1_mma_body) reads them as a
// 4-byte load where the input view's first byte and channel stride are
// multiples of 4, else the bytes below ci one by one (ci = cs = 18 and 6
// in the corpus, and any per-op input one byte into its storage); the full
// window body (conv_mma_body) finds each K position's tap and reads a tap's
// 4-channel word, or the bytes one by one (the stem, ci = 3).  K positions
// past K read 0 and are never loaded, so no read passes the tensor's
// storage (the dynamic shared memory in the arena, the allocation in
// device memory).  A tap outside the image (a 1x1 with a stride or an
// absorbed PAD; the stem's right and bottom edge in the arena) reads the
// fill.  B fragments: packed at plan time after the constants (pack_frags:
// per n8 tile and k16 step, 32 lanes x 4 bytes, K zero-padded to a
// multiple of 16), one coalesced 4-byte load a lane through the read-only
// cache; the descriptor's frag_off names them.  The accumulators start at
// the bias, and every store goes through conv_epilogue, or through
// conv_epilogue_as, its form for one epilogue, where the kernel compiles
// the body for the op's epilogue (kArenaMmaEpis ...: the epilogue chosen
// once an op, no per-element switch): int8 x int8 summed in int32 is
// exact in any order, so fast2, fast and exact bits are conv_op's by
// construction.
//
// dw3x3_words_op: a 3x3 depthwise conv, replacing conv_op<true> where the
// input view's first byte, channel stride and channel count are multiples
// of 4.  A thread owns one group of 4 channels (a 4-byte word) for the
// op: its 9 tap words of weights and its biases sit in registers; it
// walks the frame's pixels with the group fixed.  The window's bounds are
// tested once a pixel, and an interior pixel takes no per-tap test; each
// tap is one 4-byte read and four products.  Same products, same
// int32 sum, same epilogue functions: the bits are conv_op's.
//
// maxpool_words_op: a max-pool on 4-channel words, a row pass and a
// column pass through a scratch after the values (the fused kernel's
// scratch_off; the arena and section kernels' past the arena where the
// block's shared memory has room, else they keep maxpool_op), __vmaxs4 on
// words at any byte alignment.
//
// What bounds them on the card: conv_op paid a shared-memory byte and a
// weight byte through __ldg a MAC, with a bounds test per tap and two
// divisions an output element, and ran load-bound at 0.7-1.4 TMAC/s
// (PERF.md section 5); here a conv's MACs go to the tensor cores and
// its epilogue (one an output element, float or 64-bit integer work) sets
// the time, and a depthwise tap costs a word read for four MACs.  The
// kernels keep their 64 registers (4 blocks an SM): wider warp items, a
// k32 step, 8 channels a depthwise thread and every epilogue compiled in
// lost or spilled, and a max-pool walking down the rows with the window
// rows in registers lost to the row and column passes (the sweeps of PRs
// 12-13, PERF.md section 6).
//
// The exact epilogues (the counterpart of the exact branch of
// yoloface_tpu/kernels/pallas_int8.py::apply_requant_leaky, :342-396):
// each stage kernel is built twice, a template on its bit family:
// the fast instantiation with the fast sets below, and the exact one with
// kExactEpis in every body and no other epilogue (one outside it traps).
// The host launches the exact one for a program whose convs all carry
// exact epilogues (kernels/arena.py Stage.exact_convs), so no conv element
// of an exact program takes a run-time switch.  An exact fused conv+leaky
// costs one MBQM (the conv's requant),
// a clip and a byte of the op's 256-entry table: the leaky's input is the
// conv's int8 output, so the leaky is a function of 256 values, which
// conv_table fills with epilogue.cuh's leaky_exact before the body runs
// (the bits equal by construction).  The fast v1 fused leaky (the conv's
// rounding, then the leaky's) takes the same table, filled by leaky_v1,
// in the fast instantiation's bodies that know it.  The byte-view
// depthwise conv (the corpus's 18-channel stride-2 one) takes dw_bytes_op
// with its epilogue known in the exact instantiation, conv_op<true> in the
// fast one.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace yf {

// The epilogues (bit kEpi set) for which each body is compiled with its
// epilogue known (epilogue<kEpi>: no per-element switch, and the
// elements' epilogues interleave); the others take conv_epilogue at run
// time.  Interleaving takes registers, so each whole-frame kernel's fast
// instantiation has its own sets, the largest that keep it at 64
// registers without a spill, chosen by earlier variant sweeps (PERF.md
// section 6; the sweep modes went with the bodies they rejected).  The
// arena kernel (fast2 and fast bits) compiles the fast epilogues into its
// 1x1 body and the fast2 fused leaky (v2) into its depthwise and
// full-window bodies; the fused kernel (fast bits) the fast ones
// (requant, v1 fused leaky) into its 1x1 and depthwise bodies and the v1
// fused leaky into its full-window body (the stem's epilogue in its fast
// bits).  With more, both spill.  The section kernel (tiled_section.cu)
// compiles kFastEpis into every body of its fast instantiation and no
// run-time choice: conv_epilogue's exact cases in its run-time path made
// it spill at its launch bound (PERF.md section 6).  The exact
// instantiations compile kExactEpis into every body and nothing else.
constexpr unsigned kV1Epis = (1u << EPI_REQUANT) | (1u << EPI_LEAKY_V1);
constexpr unsigned kFastEpis = kV1Epis | (1u << EPI_LEAKY_V2);
// the exact instantiation's set, in every body of every stage kernel
constexpr unsigned kExactEpis =
    (1u << EPI_REQUANT_EXACT) | (1u << EPI_LEAKY_EXACT);
constexpr unsigned kArenaMmaEpis = kFastEpis;          // arena_stage.cu
constexpr unsigned kArenaConvEpis = 1u << EPI_LEAKY_V2;
constexpr unsigned kArenaDwEpis = 1u << EPI_LEAKY_V2;
constexpr unsigned kFusedMmaEpis = kV1Epis;            // fused_stage.cu
constexpr unsigned kFusedConvEpis = 1u << EPI_LEAKY_V1;
constexpr unsigned kFusedDwEpis = kV1Epis;
// the fused conv+leaky epilogues whose leaky half a body with its epilogue
// known reads from the op's table: the exact one (the second MBQM took
// 25-28% more stage time) and the fast v1 one (2-5% less than its second
// rounding in floats; PERF.md section 6)
constexpr unsigned kTableEpis = (1u << EPI_LEAKY_EXACT) | (1u << EPI_LEAKY_V1);
// the stage kernels' launch bounds: kernels/arena.py THREADS a block, and
// the fewest blocks an SM their registers must allow (4: 64 registers, as
// the kernels had before these bodies; the corpus arena's 23,520 B would
// let 9 share an SM; PERF.md section 6); the section kernel has its own
// (tiled_section.cu kSectionBlocks)
constexpr int kStageThreads = 256;
constexpr int kStageBlocks = 4;

// kEpi for an epilogue chosen element by element at run time
constexpr int kAnyEpi = -1;

// The stage kernels' 256-entry table of the op running: a standalone
// LEAKY / RELU / RELU6 / LOGISTIC (stage_table_op), or the leaky half of a
// fused conv+leaky whose epilogue is in kTableEpis (conv_table).  One
// static array serves both, so the kernels' static shared memory stays
// kTableBytes (kernels/arena.py TABLE_BYTES).
static __shared__ int8_t stage_lut[kTableBytes];

// The epilogue kEpi, or conv_epilogue's run-time choice at kAnyEpi (only
// the whole-frame kernels' fast instantiations compile a body for it).  The exact requant
// is one MBQM (mbqm32: its 32-bit halves; the 64-bit mbqm took 0-9% more
// time on the exact stages and per-op convs, PERF.md section 6), the
// exact fused leaky one MBQM and a byte of stage_lut (as is the v1 one
// where kTableEpis holds it); the others are conv_epilogue_as's.
template <int kEpi>
__device__ __forceinline__ int8_t epilogue(const Op& op, int acc, int co,
                                           const float* scale,
                                           const int* qms) {
  if constexpr (kEpi == kAnyEpi) {
    return conv_epilogue(op, acc, co, scale, qms);
  } else if constexpr (kEpi == EPI_REQUANT_EXACT) {
    return static_cast<int8_t>(clip_i8(
        mbqm32(acc, __ldg(qms + co), __ldg(qms + op.out.c + co)) +
        op.zp_out));
  } else if constexpr (((kTableEpis >> kEpi) & 1u) != 0) {
    const int r =                // the conv's int8 output, then the table
        kEpi == EPI_LEAKY_EXACT
            ? clip_i8(mbqm32(acc, __ldg(qms + co),
                             __ldg(qms + op.out.c + co)) + op.conv_zp)
            : requant_fast(acc, __ldg(scale + co), op.conv_zp);
    return stage_lut[static_cast<uint8_t>(r)];
  } else {
    return conv_epilogue_as<kEpi>(op, acc, co, scale, qms);
  }
}

// Entry u of a fused conv+leaky's table: the leaky of the conv's int8
// output (int8_t)u, v = u - conv_zp, by epilogue.cuh's own functions.
__device__ __forceinline__ int8_t conv_table_value(const Op& op, int u) {
  const int v = u - op.conv_zp;
  return op.epi == EPI_LEAKY_EXACT
             ? leaky_exact(v, op.m0, op.e0, op.m1, op.e1, op.zp_out)
             : leaky_v1(v, op.f0, op.f1, op.zp_out);
}

// Fill stage_lut for a conv whose epilogue kTabled holds (a body that
// knows the epilogue reads it), visible to the block; nothing for others.
// The op's epi is uniform across the block, so the barrier is too.
template <unsigned kTabled>
__device__ __forceinline__ void conv_table(const Op& op) {
  if constexpr (kTabled != 0) {
    if (((kTabled >> op.epi) & 1u) == 0) return;
    for (int u = threadIdx.x; u < kTableBytes; u += blockDim.x)
      stage_lut[u] = conv_table_value(op, static_cast<int8_t>(u));
    __syncthreads();
  }
}

// LEAKY_RELU, RELU, RELU6 or LOGISTIC of `rows` rows through the op's
// table in stage_lut: arena_ops.cuh's table_op on the kernels' one table.
static __device__ void stage_table_op(const Op& op, const int8_t* a,
                                      int8_t* out, int rows) {
  build_table(op, stage_lut);
  map_op(op, a, out, rows, TableFn{stage_lut});
}

// f.template run<kEpi>() with the op's epilogue as kEpi where kSet holds
// it, else with kAnyEpi (kOnly: else trap, and no kAnyEpi body is
// compiled): a body's loops hold no per-element switch for the epilogues
// of kSet.
template <unsigned kSet, bool kOnly = false, class Fn>
__device__ __forceinline__ void by_epilogue(int epi, const Fn& f) {
  switch (epi) {
    case EPI_REQUANT:
      if constexpr ((kSet >> EPI_REQUANT) & 1)
        return f.template run<EPI_REQUANT>();
      break;
    case EPI_LEAKY_V2:
      if constexpr ((kSet >> EPI_LEAKY_V2) & 1)
        return f.template run<EPI_LEAKY_V2>();
      break;
    case EPI_LEAKY_V1:
      if constexpr ((kSet >> EPI_LEAKY_V1) & 1)
        return f.template run<EPI_LEAKY_V1>();
      break;
    case EPI_REQUANT_EXACT:
      if constexpr ((kSet >> EPI_REQUANT_EXACT) & 1)
        return f.template run<EPI_REQUANT_EXACT>();
      break;
    case EPI_LEAKY_EXACT:
      if constexpr ((kSet >> EPI_LEAKY_EXACT) & 1)
        return f.template run<EPI_LEAKY_EXACT>();
      break;
  }
  if constexpr (kOnly)
    __trap();            // an epilogue the instantiation was not built for
  else
    f.template run<kAnyEpi>();
}

__device__ __forceinline__ void mma_k16(int (&d)[4], unsigned a0, unsigned a1,
                                        unsigned b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Channels [k, k + 4) of the pixel at `p` (ci channels) as an A word: one
// 4-byte load where `words` (the view's first byte and channel stride are
// multiples of 4, so a word that starts below ci ends inside the pixel's
// stride), else the bytes below ci one by one.  Channels at and past ci
// are 0 and not read.
__device__ __forceinline__ unsigned a_word4(const int8_t* p, int k, int ci,
                                            bool words) {
  if (k >= ci) return 0u;
  if (words) return *reinterpret_cast<const unsigned*>(p + k);
  unsigned w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < ci)
      w |= static_cast<unsigned>(static_cast<uint8_t>(p[k + b])) << (8 * b);
  return w;
}

// A warp item's outputs through the epilogue kEpi: acc[0], acc[1] are
// pixel p (the lane's row g), channels co, co + 1; acc[2], acc[3] pixel p
// + 8.  Pixels past m_n and channels past the output's are not stored; the
// two channels go as one 16-bit word where `pairs` (the output view
// allows).
template <int kEpi>
__device__ __forceinline__ void store_item(const Op& op, int8_t* out,
                                           const int (&acc)[4], int p, int co,
                                           int m_n, bool pairs,
                                           const uint8_t* consts) {
  const int co_n = op.out.c;
  const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
  const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
#pragma unroll
  for (int h = 0; h < 2; ++h, p += 8) {
    if (p >= m_n || co >= co_n) continue;
    int8_t* o = out + p * op.out.cs + co;
    const int8_t lo = epilogue<kEpi>(op, acc[2 * h], co, scale, qms);
    if (co + 1 < co_n) {
      const int8_t hi = epilogue<kEpi>(op, acc[2 * h + 1], co + 1, scale, qms);
      if (pairs) {
        *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(
            static_cast<uint8_t>(lo) | (static_cast<uint8_t>(hi) << 8));
      } else {
        o[0] = lo;
        o[1] = hi;
      }
    } else {
      o[0] = lo;
    }
  }
}

// A marked 1x1 CONV + epilogue kEpi (the op's) over output rows [oy0, oy0
// + rows) on the tensor cores (conv_op's contract).  All threads of the
// block take part: warp w takes the warp items w, w + warps, ..., m16
// tiles fastest.  A lane stores its two channels of a row as one 16-bit
// word where the output view allows.
template <int kEpi>
static __device__ void conv1x1_mma_body(const Op& op, const int8_t* in,
                                        int in_y0, int8_t* out, int oy0,
                                        int rows, const uint8_t* consts) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ow = op.out.w, co_n = op.out.c, ci = op.in0.c, cs = op.in0.cs;
  const int m_n = rows * ow;                               // output pixels
  in -= in_y0 * op.in0.w * cs;                             // image row 0
  const int mt = (m_n + 15) >> 4;                          // m16 tiles
  const int nt = (co_n + 7) >> 3;                          // n8 tiles
  const int ks = (ci + 15) >> 4;                           // k16 steps
  const bool words = ((addr(in) | static_cast<uintptr_t>(cs)) & 3) == 0;
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  const unsigned* frag =
      reinterpret_cast<const unsigned*>(consts + op.frag_off) + lane;
  // a 1x1 at stride 1 without a pad reads pixel p of the rows at (oy0 * ow
  // + p) * cs
  const bool direct = op.sh == 1 && op.sw == 1 && op.pt == 0 &&
                      op.pl == 0 && op.in0.w == ow && op.in0.h >= op.out.h;
  const bool pairs =            // channels 2t, 2t + 1 as one 16-bit store
      ((addr(out) | static_cast<uintptr_t>(op.out.cs)) & 1) == 0;
  const int warps = blockDim.x >> 5;
  // the warp's item: m16 tile mi of n8 tile ni, m fastest
  int mi = threadIdx.x >> 5, ni = 0;
  while (mi >= mt) mi -= mt, ++ni;
  for (; ni < nt; mi += warps) {
    while (mi >= mt) mi -= mt, ++ni;
    if (ni >= nt) break;
    const int m0 = mi * 16, co = ni * 8 + 2 * t;   // the lane's channels
    const int* bias = reinterpret_cast<const int*>(consts + op.b_off);
    const int b0 = co < co_n ? __ldg(bias + co) : 0;
    const int b1 = co + 1 < co_n ? __ldg(bias + co + 1) : 0;
    int acc[4] = {b0, b1, b0, b1};
    // the lane's rows h: pixel m0 + g + 8 h, read at in + off[h]; -1:
    // outside the image (the fill), -2: past the last pixel (0)
    int off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h;
      if (p >= m_n) {
        off[h] = -2;
      } else if (direct) {
        off[h] = (oy0 * ow + p) * cs;
      } else {
        const int oy = p / ow, ox = p - oy * ow;
        const int iy = (oy0 + oy) * op.sh - op.pt, ix = ox * op.sw - op.pl;
        off[h] = (iy < 0 || iy >= op.in0.h || ix < 0 || ix >= op.in0.w)
                     ? -1
                     : (iy * op.in0.w + ix) * cs;
      }
    }
#pragma unroll 1
    for (int s = 0; s < ks; ++s) {
      unsigned a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[h] = off[h] >= 0 ? a_word4(in + off[h], 16 * s + 4 * t, ci, words)
               : off[h] == -1 ? fill
                              : 0u;
      mma_k16(acc, a[0], a[1], __ldg(frag + (ni * ks + s) * 32));
    }
    store_item<kEpi>(op, out, acc, m0 + g, co, m_n, pairs, consts);
  }
}

// conv1x1_mma_body with the op's epilogue chosen once for the op where
// kEpis holds it.
struct Conv1x1Mma {
  const Op& op;
  const int8_t* in;
  int in_y0;
  int8_t* out;
  int oy0, rows;
  const uint8_t* consts;
  template <int kEpi>
  __device__ void run() const {
    conv1x1_mma_body<kEpi>(op, in, in_y0, out, oy0, rows, consts);
  }
};

// ceil(2**32 / d) for d >= 2, 0 for d = 1: div_by(k, d, div_magic(d)) is
// k / d for 0 <= k with k * d < 2**32 (one __umulhi instead of a division)
__device__ __forceinline__ unsigned div_magic(int d) {
  return d > 1 ? 0xffffffffu / static_cast<unsigned>(d) + 1u : 0u;
}

__device__ __forceinline__ int div_by(int k, int d, unsigned magic) {
  return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(k), magic))
               : k;
}

// The 4 bytes at p as a word, of which the first n (1 to 4) are wanted:
// the aligned words holding those bytes, funnel-shifted.  Only words that
// hold a wanted byte are read, so no read passes the tensor's storage; the
// bytes past n are whatever follows.
__device__ __forceinline__ unsigned load_word(const int8_t* p, int n) {
  const unsigned lead = static_cast<unsigned>(addr(p)) & 3u;
  const unsigned* w = reinterpret_cast<const unsigned*>(p - lead);
  if (lead == 0) return w[0];
  return __funnelshift_r(w[0], lead + n > 4 ? w[1] : 0u, 8 * lead);
}

// The tap (dy, dx, c) of K position k of a kh x kw x ci window, k = (dy *
// kw + dx) * ci + c (m_ci, m_kw: div_magic of ci and kw); false at and
// past K = k_n, where the packed weights are 0.
__device__ __forceinline__ bool k_tap(int k, int k_n, int ci, int kw,
                                      unsigned m_ci, unsigned m_kw, int& dy,
                                      int& dx, int& c) {
  const int q = div_by(k, ci, m_ci);
  c = k - q * ci;
  dy = div_by(q, kw, m_kw);
  dx = q - dy * kw;
  return k < k_n;
}

// A marked CONV with a kh x kw window (kh * kw > 1) + epilogue kEpi (the
// op's) over output rows [oy0, oy0 + rows) on the tensor cores (conv_op's
// contract), an implicit GEMM: the 1x1
// body's warp items, A rows and B fragments, with K = kh * kw * ci in (dy,
// dx, c) order, zero-padded to k16 steps.  A lane's K positions k = 16 s +
// 4 t + b are the same for every pixel: at each step it finds their taps
// (dy, dx, c) once, by multiplications, for both of its rows.  A row's
// window inside the image reads its bytes with no test; a window across
// the image's edge reads the fill at taps outside it (the corpus stem's
// top row and left column, the PAD 56 -> 57 the arena absorbs); K
// positions past K and rows past the last pixel read nothing.  Where ci,
// the channel stride and the view's first byte are multiples of 4, a K
// word is one tap's 4 channels and one 4-byte load; else (the stem: ci =
// 3, a word spans taps) it is gathered byte by byte.
template <int kEpi>
static __device__ void conv_mma_body(const Op& op, const int8_t* in,
                                     int in_y0, int8_t* out, int oy0,
                                     int rows, const uint8_t* consts) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ow = op.out.w, co_n = op.out.c, ci = op.in0.c, cs = op.in0.cs;
  const int in_h = op.in0.h, in_w = op.in0.w, kh = op.kh, kw = op.kw;
  const int k_n = kh * kw * ci;                            // K
  const int m_n = rows * ow;                               // output pixels
  in -= in_y0 * in_w * cs;                                 // image row 0
  const int mt = (m_n + 15) >> 4;                          // m16 tiles
  const int nt = (co_n + 7) >> 3;                          // n8 tiles
  const int ks = (k_n + 15) >> 4;                          // k16 steps
  const bool words = ((addr(in) | static_cast<uintptr_t>(cs) |
                       static_cast<uintptr_t>(ci)) & 3) == 0;
  const unsigned m_ci = div_magic(ci), m_kw = div_magic(kw);
  const unsigned fill8 = static_cast<uint8_t>(op.fill);
  const unsigned* frag =
      reinterpret_cast<const unsigned*>(consts + op.frag_off) + lane;
  const bool pairs =            // channels 2t, 2t + 1 as one 16-bit store
      ((addr(out) | static_cast<uintptr_t>(op.out.cs)) & 1) == 0;
  const int warps = blockDim.x >> 5;
  // the warp's item: m16 tile mi of n8 tile ni, m fastest
  int mi = threadIdx.x >> 5, ni = 0;
  while (mi >= mt) mi -= mt, ++ni;
  for (; ni < nt; mi += warps) {
    while (mi >= mt) mi -= mt, ++ni;
    if (ni >= nt) break;
    const int m0 = mi * 16, co = ni * 8 + 2 * t;   // the lane's channels
    const int* bias = reinterpret_cast<const int*>(consts + op.b_off);
    const int b0 = co < co_n ? __ldg(bias + co) : 0;
    const int b1 = co + 1 < co_n ? __ldg(bias + co + 1) : 0;
    int acc[4] = {b0, b1, b0, b1};
    // the lane's rows h: pixel m0 + g + 8 h, its window's first tap (y0,
    // x0); live: not past the last pixel; inside: the window in the image
    int y0[2], x0[2];
    bool live[2], inside[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h;
      const int oy = p / ow, ox = p - oy * ow;
      y0[h] = (oy0 + oy) * op.sh - op.pt;
      x0[h] = ox * op.sw - op.pl;
      live[h] = p < m_n;
      inside[h] = live[h] && y0[h] >= 0 && y0[h] + kh <= in_h &&
                  x0[h] >= 0 && x0[h] + kw <= in_w;
    }
#pragma unroll 1
    for (int s = 0; s < ks; ++s) {
      const int k0 = 16 * s + 4 * t;
      unsigned a[2] = {0u, 0u};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int dy, dx, c;
        if ((words && b > 0) || !k_tap(k0 + b, k_n, ci, kw, m_ci, m_kw, dy,
                                       dx, c))
          continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live[h]) continue;
          const int iy = y0[h] + dy, ix = x0[h] + dx;
          const bool inb = inside[h] || (iy >= 0 && iy < in_h && ix >= 0 &&
                                         ix < in_w);
          const int8_t* x = in + (iy * in_w + ix) * cs + c;
          if (words)
            a[h] = inb ? *reinterpret_cast<const unsigned*>(x)
                       : fill8 * 0x01010101u;
          else
            a[h] |= (inb ? static_cast<unsigned>(static_cast<uint8_t>(*x))
                         : fill8) << (8 * b);
        }
      }
      mma_k16(acc, a[0], a[1], __ldg(frag + (ni * ks + s) * 32));
    }
    store_item<kEpi>(op, out, acc, m0 + g, co, m_n, pairs, consts);
  }
}

// conv_mma_body with the op's epilogue chosen once for the op where kEpis
// holds it.
struct ConvMma {
  const Op& op;
  const int8_t* in;
  int in_y0;
  int8_t* out;
  int oy0, rows;
  const uint8_t* consts;
  template <int kEpi>
  __device__ void run() const {
    conv_mma_body<kEpi>(op, in, in_y0, out, oy0, rows, consts);
  }
};

// A marked CONV over output rows [oy0, oy0 + rows) on the tensor cores
// (conv_op's contract): a 1x1 window
// takes conv1x1_mma_body (epilogues kEpis1x1 compiled in), a full window
// conv_mma_body (kEpisFull); kOnly: those epilogues only (by_epilogue).
// conv_mma_body computes a 1x1 too, but with it on the corpus 1x1s every
// stage was 7-27% slower, in every kernel and bit semantics, than with
// conv1x1_mma_body, which reads pixel p at p * cs with no tap to find
// (tools/torch_variant_sweep.py bodies; PERF.md section 6).
template <unsigned kEpis1x1, unsigned kEpisFull, bool kOnly = false>
static __device__ void marked_conv_op(const Op& op, const int8_t* in,
                                      int in_y0, int8_t* out, int oy0,
                                      int rows, const uint8_t* consts) {
  if (op.kh == 1 && op.kw == 1)
    by_epilogue<kEpis1x1, kOnly>(
        op.epi, Conv1x1Mma{op, in, in_y0, out, oy0, rows, consts});
  else
    by_epilogue<kEpisFull, kOnly>(
        op.epi, ConvMma{op, in, in_y0, out, oy0, rows, consts});
}

// acc[b] += signed byte b of x times signed byte b of w, b = 0..3
__device__ __forceinline__ void mac4(int* acc, unsigned x, unsigned w) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    acc[b] += static_cast<int>(static_cast<int8_t>(x >> (8 * b))) *
              static_cast<int>(static_cast<int8_t>(w >> (8 * b)));
}

// 3x3 depthwise conv + epilogue kEpi (the op's) over output rows [oy0, oy0
// + rows) (conv_op's contract), a thread owning the channel word [4 q, 4 q
// + 4) for every pixel it takes.
// The caller guarantees that the input view's first byte, channel stride
// and channel count are multiples of 4 and that the block has a thread
// for each word.
template <int kEpi>
static __device__ void dw3x3_words_op(const Op& op, const int8_t* in,
                                      int in_y0, int8_t* out, int oy0,
                                      int rows, const uint8_t* consts) {
  const int c_n = op.out.c, nq = c_n >> 2;
  const int lanes = blockDim.x / nq;          // pixels walked at once
  const int q = threadIdx.x % nq, lane = threadIdx.x / nq;
  if (lane >= lanes) return;                  // the block's last threads
  const int c0 = 4 * q;
  const unsigned* w = reinterpret_cast<const unsigned*>(
      consts + op.w_off + c0);                // [1,3,3,C]: tap k at k * C
  const int* bias = reinterpret_cast<const int*>(consts + op.b_off) + c0;
  const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
  const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
  unsigned wk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wk[k] = __ldg(w + k * nq);
  int b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = __ldg(bias + j);
  const int ow = op.out.w, m_n = rows * ow;
  const int in_h = op.in0.h, in_w = op.in0.w, cs = op.in0.cs;
  in -= in_y0 * in_w * cs;                    // image row 0
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  const bool out_words =
      ((addr(out) | static_cast<uintptr_t>(op.out.cs)) & 3) == 0;
  // pixel p = oy * ow + ox, stepped by lanes = dy * ow + dx
  const int dy = lanes / ow, dx = lanes - dy * ow;
  int oy = lane / ow, ox = lane - oy * ow;
  oy += oy0;
  for (int p = lane; p < m_n; p += lanes, oy += dy, ox += dx) {
    if (ox >= ow) ox -= ow, ++oy;
    const int y0 = oy * op.sh - op.pt, x0 = ox * op.sw - op.pl;
    int acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = b[j];
    const int base = (y0 * in_w + x0) * cs + c0;   // tap (0, 0)'s word
    if (y0 >= 0 && y0 + 3 <= in_h && x0 >= 0 && x0 + 3 <= in_w) {
#pragma unroll
      for (int k = 0; k < 9; ++k)
        mac4(acc, *reinterpret_cast<const unsigned*>(
                      in + base + ((k / 3) * in_w + k % 3) * cs),
             wk[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int iy = y0 + k / 3, ix = x0 + k % 3;
        const bool inb = iy >= 0 && iy < in_h && ix >= 0 && ix < in_w;
        const unsigned* v = reinterpret_cast<const unsigned*>(
            in + base + ((k / 3) * in_w + k % 3) * cs);
        mac4(acc, inb ? *v : fill, wk[k]);
      }
    }
    int8_t* o = out + p * op.out.cs + c0;
    unsigned r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r |= static_cast<unsigned>(static_cast<uint8_t>(
               epilogue<kEpi>(op, acc[j], c0 + j, scale, qms)))
           << (8 * j);
    if (out_words) {
      *reinterpret_cast<unsigned*>(o) = r;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = static_cast<int8_t>(r >> (8 * j));
    }
  }
}

// dw3x3_words_op with the op's epilogue.
struct Dw3x3Words {
  const Op& op;
  const int8_t* in;
  int in_y0;
  int8_t* out;
  int oy0, rows;
  const uint8_t* consts;
  template <int kEpi>
  __device__ void run() const {
    dw3x3_words_op<kEpi>(op, in, in_y0, out, oy0, rows, consts);
  }
};

// A depthwise conv + epilogue kEpi over output rows [oy0, oy0 + rows)
// (conv_op's contract), an output byte a thread step: conv_op<true>'s loop
// (the same taps, fill and int32 sum) storing through epilogue<kEpi>.
template <int kEpi>
static __device__ void dw_bytes_op(const Op& op, const int8_t* in, int in_y0,
                                   int8_t* out, int oy0, int rows,
                                   const uint8_t* consts) {
  const int8_t* w = reinterpret_cast<const int8_t*>(consts + op.w_off);
  const int* bias = reinterpret_cast<const int*>(consts + op.b_off);
  const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
  const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
  const int co_n = op.out.c;
  const int total = rows * op.out.w * co_n;
  in -= in_y0 * op.in0.w * op.in0.cs;         // image row 0
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
        const int xv = inb ? in[(iy * op.in0.w + ix) * op.in0.cs + co]
                           : op.fill;
        acc += xv * __ldg(w + (dy * op.kw + dx) * co_n + co);
      }
    }
    out[p * op.out.cs + co] = epilogue<kEpi>(op, acc, co, scale, qms);
  }
}

// dw_bytes_op with the op's epilogue.
struct DwBytes {
  const Op& op;
  const int8_t* in;
  int in_y0;
  int8_t* out;
  int oy0, rows;
  const uint8_t* consts;
  template <int kEpi>
  __device__ void run() const {
    dw_bytes_op<kEpi>(op, in, in_y0, out, oy0, rows, consts);
  }
};

// DW + epilogue over output rows [oy0, oy0 + rows) (conv_op's contract): a
// 3x3 window on a view of 4-byte
// channel words (its first byte, channel stride and channel count
// multiples of 4, at most 4 channels a thread of the block) takes
// dw3x3_words_op (Dw3x3Words; the op's epilogue chosen once where kEpis
// holds it); any other takes conv_op<true>, or with kOnly (kEpis only,
// by_epilogue) dw_bytes_op the same way.
template <unsigned kEpis, bool kOnly = false>
static __device__ void dw_op(const Op& op, const int8_t* in, int in_y0,
                             int8_t* out, int oy0, int rows,
                             const uint8_t* consts) {
  const int c_n = op.out.c;
  if (op.kh != 3 || op.kw != 3 || c_n > 4 * static_cast<int>(blockDim.x) ||
      ((addr(in) | static_cast<uintptr_t>(op.in0.cs) |
        static_cast<uintptr_t>(c_n)) & 3) != 0) {
    if constexpr (kOnly)
      by_epilogue<kEpis, true>(
          op.epi, DwBytes{op, in, in_y0, out, oy0, rows, consts});
    else
      conv_op<true>(op, in, in_y0, out, oy0, rows, consts);
    return;
  }
  by_epilogue<kEpis, kOnly>(
      op.epi, Dw3x3Words{op, in, in_y0, out, oy0, rows, consts});
}

// The max of input row iy over the kw taps from column x0 of the channel
// word at channel offset `c` of a pixel (n wanted channels), lane by lane:
// the fill at taps and rows outside the image, as maxpool_op reads them.
__device__ __forceinline__ unsigned pool_row(const Op& op, const int8_t* in,
                                             int iy, int x0, int c, int n,
                                             unsigned fill) {
  if (iy < 0 || iy >= op.in0.h) return fill;
  const int8_t* row = in + iy * op.in0.w * op.in0.cs + c;
  unsigned m = 0x80808080u;                  // -128 in every lane
  for (int dx = 0; dx < op.kw; ++dx) {
    const int ix = x0 + dx;
    m = __vmaxs4(m, ix >= 0 && ix < op.in0.w
                        ? load_word(row + ix * op.in0.cs, n)
                        : fill);
  }
  return m;
}

// MAX_POOL over output rows [oy0, oy0 + rows) (conv_op's contract) on words
// of 4 channels (the last word of a pixel holds c % 4 of them where 4 does
// not divide c), separably: a row pass takes the horizontal max over the
// kw taps of each of the (rows - 1) * sh + kh input rows the windows span,
// from image row oy0 * sh - pt on, at each output column, into `scratch`
// (kernels/arena.py pool_scratch: that many rows of ow words a channel
// word); a column pass takes the max over kh of those rows for each output
// pixel.  Every thread of the block takes (row or pixel,
// channel word) items.  __vmaxs4 compares 4 channels at once, kw + kh
// compares a word against maxpool_op's kh * kw byte loads an output byte;
// words at any byte alignment (cs = 18, a view one byte in) are
// funnel-shifted from aligned loads (load_word).  A row outside the image
// is the fill, as every tap of it is in maxpool_op: the same compares,
// the bits of maxpool_op.
static __device__ void maxpool_words_op(const Op& op, const int8_t* in,
                                        int in_y0, int8_t* out, int oy0,
                                        int rows, unsigned* scratch) {
  const int c_n = op.out.c, nq = (c_n + 3) >> 2, ow = op.out.w;
  const int n_rows = (rows - 1) * op.sh + op.kh;
  const int iy0 = oy0 * op.sh - op.pt;        // the first row's image row
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  in -= in_y0 * op.in0.w * op.in0.cs;         // image row 0
  for (int e = threadIdx.x; e < n_rows * ow * nq; e += blockDim.x) {
    const int q = e % nq, r = e / nq, ox = r % ow, row = r / ow;
    scratch[e] = pool_row(op, in, iy0 + row, ox * op.sw - op.pl, 4 * q,
                          min(4, c_n - 4 * q), fill);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * ow * nq; e += blockDim.x) {
    const int q = e % nq, p = e / nq, ox = p % ow, oy = p / ow;
    const unsigned* col = scratch + (oy * op.sh * ow + ox) * nq + q;
    unsigned m = col[0];
    for (int dy = 1; dy < op.kh; ++dy) m = __vmaxs4(m, col[dy * ow * nq]);
    int8_t* o = out + p * op.out.cs + 4 * q;
    const int n = min(4, c_n - 4 * q);
    if (n == 4 && (addr(o) & 3) == 0) {
      *reinterpret_cast<unsigned*>(o) = m;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < n) o[b] = static_cast<int8_t>(m >> (8 * b));
    }
  }
}

// The shared memory stage_view takes for an input of n bytes: the view at
// its offset within 16 bytes, rounded up to 16 (kernels/arena.py
// pool_scratch, the planners' copy).
__device__ __forceinline__ int staged_bytes(int n) { return (n + 31) & ~15; }

// A frame's input view in device memory (in0: h * w * cs bytes from `in`)
// copied into shared memory at `dst` + its offset within 16 bytes, so that
// both sides share their alignment: the bytes up to the first 16-byte
// boundary one by one, the rest by map_flat (16-byte chunks, four loads in
// flight); -> the copy, visible to the block.  No read passes the view.
__device__ __forceinline__ const int8_t* stage_view(const Op& op,
                                                    const int8_t* in,
                                                    int8_t* dst) {
  const int n = op.in0.h * op.in0.w * op.in0.cs;
  const int lead = static_cast<int>(addr(in) & 15);
  const int head = min(n, (16 - lead) & 15);
  int8_t* d = dst + lead;
  if (static_cast<int>(threadIdx.x) < head) d[threadIdx.x] = in[threadIdx.x];
  map_flat<int>(in + head, d + head, n - head, CopyFn{}, threadIdx.x,
                blockDim.x);
  __syncthreads();
  return d;
}

// The per-descriptor cycle counters of a traced stage kernel (its kTrace
// instantiation; kernels/arena.py and kernels/tiled.py launch it while a
// torch.profiler session records, runtime/profiler.py stage_cycles reads
// the sums): thread 0 of a block reads clock64() after op i's closing
// barrier and adds the cycles since the previous barrier (the kernel's
// start, for op 0) to counts[i], one atomic an op a block.  The previous
// reading stays in shared memory: held in a register across the op bodies
// it spilled in the arena kernel's 64.  An untraced instantiation compiles
// none of it.
template <bool kTrace>
struct OpCycles {
  unsigned long long* counts;

  __device__ __forceinline__ static long long& last() {
    __shared__ long long t;
    return t;
  }

  __device__ __forceinline__ explicit OpCycles(unsigned long long* c)
      : counts(c) {
    if constexpr (kTrace) {
      if (threadIdx.x == 0) last() = clock64();
    }
  }

  // after op i's closing __syncthreads()
  __device__ __forceinline__ void after(int i) {
    if constexpr (kTrace) {
      if (threadIdx.x == 0) {
        const long long now = clock64();
        atomicAdd(counts + i, static_cast<unsigned long long>(now - last()));
        last() = now;
      }
    }
  }
};

// A whole-frame kernel as the build compiled it: out[0..3] = registers a
// thread, local bytes a thread, static shared bytes, and the blocks of
// `threads` threads with `smem_bytes` of dynamic shared memory an SM holds.
template <class K>
int kernel_attrs(K kernel, int threads, int smem_bytes, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace yf
