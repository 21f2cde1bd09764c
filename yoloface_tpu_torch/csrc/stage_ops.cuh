// The conv bodies of the whole-frame stage kernels (arena_stage.cu and
// fused_stage.cu, which also runs the per-op programs); the tiled section
// kernel does not include this header and keeps arena_ops.cuh's conv_op.
//
// conv1x1_mma_op: a 1x1 CONV that the planners mark (kernels/arena.py
// mark_mma) on the int8 tensor cores, replacing conv_op<false> for it.
// The JAX stage kernel runs these convs on the MXU in its own body
// (yoloface_tpu/kernels/pallas_arena.py:358, :384).  An implicit GEMM:
//  * M: the output pixels of the frame (784, 196 or 49 in the corpus net),
//    in m16 tiles; the last is ragged, its rows past the end read 0 and
//    are not stored;
//  * N: the output channels (4 to 40), in n8 tiles; the last is masked on
//    store;
//  * K: the input channels ci (4 to 48), in k16 steps of
//    mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32.
// A warp item is one m16 tile by one n8 tile.
// A fragments: lane (g, t) holds channels 4t..4t+3 of pixel g (and g + 8)
// of its k16 step; a 4-byte load where the input view's first byte and
// channel stride are multiples of 4, else the bytes below ci gathered one
// by one (ci = cs = 18 and 6 in the corpus, and any per-op input one byte
// into its storage); channels at and past ci read 0 and are never loaded,
// so no read passes the tensor's storage (the dynamic shared memory in
// the arena, the allocation in device memory).  A pixel whose window lies
// outside the image (a 1x1 with a stride or an absorbed PAD) reads the
// fill.  B fragments: packed at plan time after the constants (pack_frags:
// per n8 tile and k16 step, 32 lanes x 4 bytes, ci zero-padded to a
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
// What bounds them on the card: conv_op paid a shared-memory byte and a
// weight byte through __ldg a MAC, with a bounds test per tap and two
// divisions an output element, and ran load-bound at 0.7-1.4 TMAC/s
// (PERF.md section 5); here a 1x1 conv's MACs go to the tensor cores and
// its epilogue (one an output element, float or 64-bit integer work) sets
// the time, and a depthwise tap costs a word read for four MACs.  The
// kernels keep their 64 registers (4 blocks an SM): wider warp items, a
// k32 step, 8 channels a depthwise thread and every epilogue compiled in
// lost or spilled (tools/torch_variant_sweep.py arena_mma, dw4; PERF.md
// section 6).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace yf {

// The epilogues (bit kEpi set) for which each body is compiled with its
// epilogue known (conv_epilogue_as<kEpi>: no per-element switch, and the
// elements' epilogues interleave); the others take conv_epilogue at run
// time.  Interleaving takes registers, so each kernel has its own sets,
// the largest that keep it at 64 registers without a spill, chosen by
// tools/torch_variant_sweep.py arena_mma and fused_mma (PERF.md section
// 6): the arena kernel (fast2, fast and exact bits) compiles the fast
// epilogues into its 1x1 body and the fast2 fused leaky (v2) into its
// depthwise body; the fused kernel (fast and exact bits) the fast ones
// (requant, v1 fused leaky) into both.  With the exact ones too, both
// spill.
constexpr unsigned kV1Epis = (1u << EPI_REQUANT) | (1u << EPI_LEAKY_V1);
constexpr unsigned kFastEpis = kV1Epis | (1u << EPI_LEAKY_V2);
constexpr unsigned kArenaMmaEpis = kFastEpis;          // arena_stage.cu
constexpr unsigned kArenaDwEpis = 1u << EPI_LEAKY_V2;
constexpr unsigned kFusedMmaEpis = kV1Epis;            // fused_stage.cu
constexpr unsigned kFusedDwEpis = kV1Epis;
// the whole-frame kernels' launch bounds: kernels/arena.py THREADS a
// block, and the fewest blocks an SM their registers must allow (4: 64
// registers, as the kernels had before these bodies; the corpus arena's
// 23,520 B would let 9 share an SM; tools/torch_variant_sweep.py
// arena_mma)
constexpr int kStageThreads = 256;
constexpr int kStageBlocks = 4;

// kEpi for an epilogue chosen element by element at run time
constexpr int kAnyEpi = -1;

// The epilogue kEpi, or conv_epilogue's run-time choice at kAnyEpi.
template <int kEpi>
__device__ __forceinline__ int8_t epilogue(const Op& op, int acc, int co,
                                           const float* scale,
                                           const int* qms) {
  if constexpr (kEpi == kAnyEpi)
    return conv_epilogue(op, acc, co, scale, qms);
  else
    return conv_epilogue_as<kEpi>(op, acc, co, scale, qms);
}

// f.template run<kEpi>() with the op's epilogue as kEpi where kSet holds
// it, else with kAnyEpi: a body's loops hold no per-element switch for the
// epilogues of kSet.
template <unsigned kSet, class Fn>
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

// A marked 1x1 CONV + epilogue kEpi (the op's) over the whole frame on the
// tensor cores; `in` and `out` point at the views' first bytes.  All
// threads of the block take part: warp w takes the warp items w, w +
// warps, ..., m16 tiles fastest.  A lane stores its two channels of a row
// as one 16-bit word where the output view allows.
template <int kEpi>
static __device__ void conv1x1_mma_body(const Op& op, const int8_t* in,
                                        int8_t* out, const uint8_t* consts) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ow = op.out.w, co_n = op.out.c, ci = op.in0.c, cs = op.in0.cs;
  const int m_n = op.out.h * ow;                           // output pixels
  const int mt = (m_n + 15) >> 4;                          // m16 tiles
  const int nt = (co_n + 7) >> 3;                          // n8 tiles
  const int ks = (ci + 15) >> 4;                           // k16 steps
  const bool words = ((addr(in) | static_cast<uintptr_t>(cs)) & 3) == 0;
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  const unsigned* frag =
      reinterpret_cast<const unsigned*>(consts + op.frag_off) + lane;
  // a 1x1 at stride 1 without a pad reads pixel p of the input at p * cs
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
        off[h] = p * cs;
      } else {
        const int oy = p / ow, ox = p - oy * ow;
        const int iy = oy * op.sh - op.pt, ix = ox * op.sw - op.pl;
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
    // acc[0], acc[1]: row g, channels co, co + 1; acc[2], acc[3]: row g + 8
    const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
    const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h;
      if (p >= m_n || co >= co_n) continue;
      int8_t* o = out + p * op.out.cs + co;
      const int8_t lo = epilogue<kEpi>(op, acc[2 * h], co, scale, qms);
      if (co + 1 < co_n) {
        const int8_t hi =
            epilogue<kEpi>(op, acc[2 * h + 1], co + 1, scale, qms);
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
}

// conv1x1_mma_body with the op's epilogue chosen once for the op where
// kEpis holds it.
struct Conv1x1Mma {
  const Op& op;
  const int8_t* in;
  int8_t* out;
  const uint8_t* consts;
  template <int kEpi>
  __device__ void run() const {
    conv1x1_mma_body<kEpi>(op, in, out, consts);
  }
};

template <unsigned kEpis>
static __device__ void conv1x1_mma_op(const Op& op, const int8_t* in,
                                      int8_t* out, const uint8_t* consts) {
  by_epilogue<kEpis>(op.epi, Conv1x1Mma{op, in, out, consts});
}

// acc[b] += signed byte b of x times signed byte b of w, b = 0..3
__device__ __forceinline__ void mac4(int* acc, unsigned x, unsigned w) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    acc[b] += static_cast<int>(static_cast<int8_t>(x >> (8 * b))) *
              static_cast<int>(static_cast<int8_t>(w >> (8 * b)));
}

// 3x3 depthwise conv + epilogue kEpi (the op's) over the whole frame, a
// thread owning the channel word [4 q, 4 q + 4) for every pixel it takes.
// The caller guarantees that the input view's first byte, channel stride
// and channel count are multiples of 4 and that the block has a thread
// for each word.
template <int kEpi>
static __device__ void dw3x3_words_op(const Op& op, const int8_t* in,
                                      int8_t* out, const uint8_t* consts) {
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
  const int ow = op.out.w, m_n = op.out.h * ow;
  const int in_h = op.in0.h, in_w = op.in0.w, cs = op.in0.cs;
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  const bool out_words =
      ((addr(out) | static_cast<uintptr_t>(op.out.cs)) & 3) == 0;
  // pixel p = oy * ow + ox, stepped by lanes = dy * ow + dx
  const int dy = lanes / ow, dx = lanes - dy * ow;
  int oy = lane / ow, ox = lane - oy * ow;
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
  int8_t* out;
  const uint8_t* consts;
  template <int kEpi>
  __device__ void run() const {
    dw3x3_words_op<kEpi>(op, in, out, consts);
  }
};

// DW + epilogue over the whole frame: a 3x3 window on a view of 4-byte
// channel words (its first byte, channel stride and channel count
// multiples of 4, at most 4 channels a thread of the block) takes
// dw3x3_words_op (Dw3x3Words; the op's epilogue chosen once where kEpis
// holds it); any other takes conv_op<true>.
template <unsigned kEpis>
static __device__ void dw_op(const Op& op, const int8_t* in, int8_t* out,
                             const uint8_t* consts) {
  const int c_n = op.out.c;
  if (op.kh != 3 || op.kw != 3 || c_n > 4 * static_cast<int>(blockDim.x) ||
      ((addr(in) | static_cast<uintptr_t>(op.in0.cs) |
        static_cast<uintptr_t>(c_n)) & 3) != 0) {
    conv_op<true>(op, in, 0, out, 0, op.out.h, consts);
    return;
  }
  by_epilogue<kEpis>(op.epi, Dw3x3Words{op, in, out, consts});
}

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
