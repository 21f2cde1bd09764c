// The big-K convs of a tiled section on the int8 tensor cores: an implicit
// GEMM over the strip band, with mma.sync.aligned.m16n8k32.row.col.s32.s8.s8
// .s32 (the fragment code of probe_conv.cu's MMA8 variant, B9.1).
//
// Replaces, for the CONV ops the tiled planner marks for it
// (kernels/tiled.py MMA_MIN_K: not depthwise, ci a multiple of 16),
// stage_ops.cuh's m16n8k16 conv bodies inside
// yoloface_tpu/kernels/pallas_tiled.py::_build_tiled_section's counterpart
// (tiled_section.cu): on yolov3-tiny's big-K convs it took 4.3x less time
// (tools/torch_variant_sweep.py mma; PERF.md section 6).  The product:
//  * M: the op's output pixels of the strip (rows x out.w), in m16 tiles;
//    the last tile is ragged and its rows past the end are masked;
//  * N: the output channels, in n8 tiles; the last is ragged (the 255
//    channels of yolov3-tiny's heads) and masked on store;
//  * K: taps x ci, tap by tap, each tap's ci zero-padded to a multiple of
//    32 (k32 steps).
// A fragments: 32-bit loads of 4 channels of one pixel from the band (the
// conv's input view); a tap outside the image gives op.fill, the input
// zero-point, in every byte, exactly as conv_op's inb test does, and so do
// rows past the last pixel and the zero-weighted upper half of a k32 step
// past ci.  B fragments: the planner writes a second copy of the weights
// into the section's constants in m16n8k32 B-fragment order (per n8 tile
// and k32 step, 32 lanes x 2 words: lane (g, t) holds W[n0 + g][k0 + 4t ..]
// and W[n0 + g][k0 + 16 + 4t ..]), so a warp loads a fragment with one
// coalesced 8-byte load a lane through the read-only cache; its offset is
// the StripOp's mma_off.  Accumulators start at bias[co]; the store goes
// through stage_ops.cuh's epilogue<kEpi>, the op's epilogue (the section
// kernel's k32 instantiations choose it once an op with by_epilogue, each
// from its bit family's epilogues only), so fast2, fast and exact
// bits are conv_op's by construction: int8 x int8 summed in int32 is exact
// in any order.
//
// What bounds it on the card: the int8 tensor cores' rate bounds the
// work, but this first version is held by its loads.  A warp item is one
// m16 tile by kMmaNt n8 tiles, so each B fragment (8 bytes a lane, from L2)
// serves one mma of 16 pixels: a strip of one 13-pixel row (yolov3-tiny's
// layer 12) reads all of a conv's weights once a block.  The A loads meet
// bank conflicts where a pixel's channel stride is a multiple of 128 bytes
// (the 8 rows of a fragment on the same 4 banks).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"
#include "stage_ops.cuh"

namespace yf {

constexpr int kMmaNt = 4;   // n8 tiles (32 output channels) a warp item

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four channels of one pixel as an A word: `p` is 4-byte aligned (the
// planner marks only convs whose channel count and stride are multiples
// of 16, and views start 16-byte aligned).
__device__ __forceinline__ unsigned a_word(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// CONV + epilogue kEpi over output rows [oy0, oy0 + rows) on the tensor
// cores; `in` holds the input's image rows from in_y0 on, `out` points at
// output row oy0 (conv_op's contract).  All threads of the block take
// part: warp w takes the warp items w, w + warps, ..., m16 tiles fastest,
// so the warps at work at once share the B fragments of one n8 group.
template <int kEpi>
static __device__ void conv_mma_op(const Op& op, const int8_t* in, int in_y0,
                                   int8_t* out, int oy0, int rows,
                                   const uint8_t* consts, int mma_off) {
  // the constants' addresses are formed where they are read, from
  // `consts`, so that no 64-bit pointer but `in`, `out` and `consts` stays
  // live through the loops
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ow = op.out.w, co_n = op.out.c, ci = op.in0.c, cs = op.in0.cs;
  const int m_n = rows * ow;                   // output pixels
  const int mt = (m_n + 15) >> 4;              // m16 tiles
  const int nt = (co_n + 7) >> 3;              // n8 tiles
  const int kc = (ci + 31) >> 5;               // k32 steps a tap
  const int ks = op.kh * op.kw * kc;           // k32 steps
  const unsigned fill = static_cast<unsigned>(static_cast<uint8_t>(op.fill)) *
                        0x01010101u;
  const int items = mt * ((nt + kMmaNt - 1) / kMmaNt);
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int m0 = (it % mt) * 16, n0 = (it / mt) * kMmaNt;   // n0: n8 tiles
    int acc[kMmaNt][4];
#pragma unroll
    for (int j = 0; j < kMmaNt; ++j) {
      const int co = (n0 + j) * 8 + 2 * t;
      const int* bias = reinterpret_cast<const int*>(consts + op.b_off);
      acc[j][0] = acc[j][2] = co < co_n ? __ldg(bias + co) : 0;
      acc[j][1] = acc[j][3] = co + 1 < co_n ? __ldg(bias + co + 1) : 0;
    }
    // the lane's two rows of the tile: output pixels pa and pb; 32-bit
    // byte offsets (from `in`, and in fragments from mma_off) keep the
    // loop's live registers few
    const int pa = m0 + g, pb = pa + 8;
    const int ya = (oy0 + pa / ow) * op.sh - op.pt;
    const int xa = (pa % ow) * op.sw - op.pl;
    const int yb = (oy0 + pb / ow) * op.sh - op.pt;
    const int xb = (pb % ow) * op.sw - op.pl;
    // this lane's B fragment (n0, k step 0), in 8-byte units from mma_off
    int wk = n0 * ks * 32 + lane;
#pragma unroll 1
    for (int dy = 0; dy < op.kh; ++dy) {
#pragma unroll 1
      for (int dx = 0; dx < op.kw; ++dx, wk += kc * 32) {
        const int iya = ya + dy, iyb = yb + dy, ixa = xa + dx, ixb = xb + dx;
        const bool ina = pa < m_n && iya >= 0 && iya < op.in0.h && ixa >= 0 &&
                         ixa < op.in0.w;
        const bool inb = pb < m_n && iyb >= 0 && iyb < op.in0.h && ixb >= 0 &&
                         ixb < op.in0.w;
        const int oa = ((iya - in_y0) * op.in0.w + ixa) * cs + 4 * t;
        const int ob = ((iyb - in_y0) * op.in0.w + ixb) * cs + 4 * t;
#pragma unroll 1
        for (int c = 0; c < kc; ++c) {
          const int cb = 32 * c;
          const bool hi = cb + 16 < ci;      // else zero weights: any value
          const unsigned a0 = ina ? a_word(in + oa + cb) : fill;
          const unsigned a1 = inb ? a_word(in + ob + cb) : fill;
          const unsigned a2 = ina && hi ? a_word(in + oa + cb + 16) : fill;
          const unsigned a3 = inb && hi ? a_word(in + ob + cb + 16) : fill;
          uint2 b[kMmaNt];
#pragma unroll
          for (int j = 0; j < kMmaNt; ++j)
            if (n0 + j < nt)
              b[j] = __ldg(reinterpret_cast<const uint2*>(consts + mma_off) +
                           wk + (j * ks + c) * 32);
#pragma unroll
          for (int j = 0; j < kMmaNt; ++j)
            if (n0 + j < nt) mma_s8(acc[j], a0, a1, a2, a3, b[j].x, b[j].y);
        }
      }
    }
    // c0, c1: row g, channels 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
    for (int j = 0; j < kMmaNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = e < 2 ? pa : pb;
        const int co = (n0 + j) * 8 + 2 * t + (e & 1);
        if (p < m_n && co < co_n)
          out[p * op.out.cs + co] = epilogue<kEpi>(
              op, acc[j][e], co,
              reinterpret_cast<const float*>(consts + op.s_off),
              reinterpret_cast<const int*>(consts + op.q_off));
      }
    }
  }
}

// conv_mma_op with the op's epilogue chosen once for the op (by_epilogue).
struct ConvK32 {
  const Op& op;
  const int8_t* in;
  int in_y0;
  int8_t* out;
  int oy0, rows;
  const uint8_t* consts;
  int mma_off;
  template <int kEpi>
  __device__ void run() const {
    conv_mma_op<kEpi>(op, in, in_y0, out, oy0, rows, consts, mma_off);
  }
};

}  // namespace yf
