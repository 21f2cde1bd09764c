// Depthwise 3x3 taps and the fast-requant chain of the tools/ probes.
//
// Replaces the tap kernels of tools/microbench.py: main (:633, the
// dw-shaped variants: taps with and without offsets, stride 2, an int8 or
// int32 arena, a >> 7, fast (f32) or exact (MBQM) requant, borders copied),
// whcn_probe (:131, the taps in the frame-innermost [S,S,C,N] layout),
// inkernel_probe (:264, taps repeated R times on chip, and the fast requant
// chain round(acc * f32(1e-4 * (r + 1))) + 3) and dw16_probe (:412, int32
// against int16 arithmetic, R times).  Plain versions: kernels/probes.py.
// The int8 NHWC cases of main also run on probe_dw_frames.cu (a block a
// group of whole frames, the probe's headline); these are their "(PR 7)"
// forms.
//
// One thread an output element, walking the output in its memory order:
// NHWC (channel fastest, the port's arena layout: a warp is 32 channels of
// a few pixels, the taps a coalesced row of the [9, C] table) or frame
// innermost [H, W, C, N] (a warp is 32 frames of one pixel and channel, so
// every lane reads the same tap: a broadcast).  A thread loads its nine
// inputs once into registers; the R repetitions then run on registers
// alone, each with the taps plus r, and r passes through an empty asm so
// the compiler can neither hoist a repetition nor sum the series in closed
// form.  That makes the R-times form a measure of the CUDA cores' integer
// rate.  The 16-bit form packs two taps plus r as the int16 halves of one
// register (__vadd2, which wraps each half as JAX's int16 cast of the tap
// does) and the int8 inputs as bytes, and takes two multiply-adds an
// instruction with __dp2a_lo / __dp2a_hi: int16 wrap is arithmetic mod
// 2**16, so the int32 sum stored as int16 has the bits of int16
// accumulators, whatever the taps.
//
// What bounds it on the card: at R = 1 device-memory bandwidth (9 MACs a
// byte read); at R = 16 the integer pipes.  Requant comes from
// epilogue.cuh: round_zp_clip for the fast form, requant_exact's 64-bit
// MBQM for the exact one.
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

enum Kind { TAPS = 0, REQ_CHAIN = 1 };
enum Epi { SHIFT = 0, FAST = 1, EXACT = 2, RAW = 3 };
enum Border { COPY = 0, ZERO = 1, NONE = 2 };

struct DwParams {
  int n, sp, c;        // input [n, sp, sp, c] in its layout
  int so, osp, o0;     // computed region so x so at (o0, o0) of an osp output
  int stride, offs;    // tap (dy, dx) reads input (y*stride + dy, ...) if offs
  int epi, qm, shift, border, reps;
};

__device__ __forceinline__ int opaque(int r) {
  asm volatile("" : "+r"(r));
  return r;
}

template <int kKind, typename InT, typename OutT, bool kFI, bool kDp2a>
__global__ void __launch_bounds__(256)
    probe_dw_kernel(const InT* __restrict__ x, const int* __restrict__ taps,
                    const float* __restrict__ scale, OutT* __restrict__ out,
                    DwParams p) {
  // 32-bit index math: the wrapper keeps every tensor below 2**31
  // elements (64-bit division dominated the first version's time)
  const int total = p.n * p.osp * p.osp * p.c;
  const int step = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += step) {
    if constexpr (kKind == REQ_CHAIN) {   // elementwise: out has x's shape
      const float v = static_cast<float>(static_cast<int>(x[e]) * 1000);
      int s = 0;
      for (int r = 0; r < p.reps; ++r) {
        const float m = __fmul_rn(v, static_cast<float>(1e-4 * (r + 1)));
        const float t = __fadd_rn(rintf(m), 3.0f);
        s += static_cast<int>(fminf(fmaxf(t, -128.0f), 127.0f));
      }
      out[e] = static_cast<OutT>(s);
      continue;
    }
    int n, oy, ox, ch, q = e;
    if (kFI) {
      n = q % p.n; q /= p.n;
      ch = q % p.c; q /= p.c;
      ox = q % p.osp; oy = q / p.osp;
    } else {
      ch = q % p.c; q /= p.c;
      ox = q % p.osp; q /= p.osp;
      oy = q % p.osp; n = q / p.osp;
    }
    auto at = [&](int y, int xx) -> int {
      return kFI ? ((y * p.sp + xx) * p.c + ch) * p.n + n
                 : ((n * p.sp + y) * p.sp + xx) * p.c + ch;
    };
    const int ry = oy - p.o0, rx = ox - p.o0;
    if (ry < 0 || ry >= p.so || rx < 0 || rx >= p.so) {   // the border
      out[e] = p.border == COPY ? static_cast<OutT>(x[at(oy, ox)]) : OutT(0);
      continue;
    }
    int xv[9], wv[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int dy = p.offs ? k / 3 : 0, dx = p.offs ? k % 3 : 0;
      xv[k] = static_cast<int>(x[at(ry * p.stride + dy, rx * p.stride + dx)]);
      wv[k] = __ldg(taps + k * p.c + ch);
    }
    int acc = 0;
    if constexpr (kDp2a) {
      unsigned wp[5];       // (tap 2i, tap 2i+1) as int16 halves, tap 9 = 0
      unsigned xb[3] = {0u, 0u, 0u};   // the int8 inputs as bytes, 4 a word
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const unsigned hi =
            2 * i + 1 < 9 ? static_cast<unsigned>(wv[2 * i + 1]) << 16 : 0u;
        wp[i] = hi | (static_cast<unsigned>(wv[2 * i]) & 0xFFFFu);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k)
        xb[k / 4] |= (static_cast<unsigned>(xv[k]) & 0xFFu) << (8 * (k % 4));
      const int a = static_cast<int>(xb[0]), b = static_cast<int>(xb[1]),
                c = static_cast<int>(xb[2]);
      for (int r = 0; r < p.reps; ++r) {
        const unsigned d = static_cast<unsigned>(opaque(r)) * 0x00010001u;
        acc = __dp2a_lo(static_cast<int>(__vadd2(wp[0], d)), a, acc);
        acc = __dp2a_hi(static_cast<int>(__vadd2(wp[1], d)), a, acc);
        acc = __dp2a_lo(static_cast<int>(__vadd2(wp[2], d)), b, acc);
        acc = __dp2a_hi(static_cast<int>(__vadd2(wp[3], d)), b, acc);
        acc = __dp2a_lo(static_cast<int>(__vadd2(wp[4], d)), c, acc);
      }
    } else {
      for (int r = 0; r < p.reps; ++r) {
        const int rr = opaque(r);
#pragma unroll
        for (int k = 0; k < 9; ++k) acc += xv[k] * (wv[k] + rr);
      }
    }
    int v;
    switch (p.epi) {     // uniform across the launch
      case SHIFT: v = yf::clip_i8(acc >> 7); break;
      case FAST:
        v = yf::round_zp_clip(__fmul_rn(static_cast<float>(acc),
                                        __ldg(scale + ch)), 0);
        break;
      case EXACT: v = yf::requant_exact(acc, p.qm, p.shift, 0); break;
      default: v = acc;
    }
    out[e] = static_cast<OutT>(v);
  }
}

template <int kKind, typename InT, typename OutT, bool kFI, bool kDp2a>
int launch(const void* x, const void* taps, const void* scale, void* out,
           const DwParams& p, cudaStream_t stream) {
  const long long total =
      static_cast<long long>(p.n) * p.osp * p.osp * p.c;
  if (total >= (1LL << 31) ||
      static_cast<long long>(p.n) * p.sp * p.sp * p.c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  probe_dw_kernel<kKind, InT, OutT, kFI, kDp2a>
      <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
          static_cast<const InT*>(x), static_cast<const int*>(taps),
          static_cast<const float*>(scale), static_cast<OutT*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params: kind, frame innermost (0/1), input bytes (1/4), output bytes
// (1/2/4), 16-bit arithmetic (0/1), then DwParams in order.  Taps are int32
// [9, C] (tap dy*3+dx major), scale float32 [C] (fast requant only).
extern "C" int yf_probe_dw(const void* x, const void* taps, const void* scale,
                           void* out, const int* params, void* stream) {
  const int kind = params[0], fi = params[1], ib = params[2], ob = params[3];
  const int dp2a = params[4];
  DwParams p;
  if (params[5] <= 0 || params[9] <= 0 || params[7] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.n = params[5]; p.sp = params[6]; p.c = params[7];
  p.so = params[8]; p.osp = params[9]; p.o0 = params[10];
  p.stride = params[11]; p.offs = params[12];
  p.epi = params[13]; p.qm = params[14]; p.shift = params[15];
  p.border = params[16]; p.reps = params[17];
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == REQ_CHAIN && ib == 1 && ob == 4 && !dp2a)
    return launch<REQ_CHAIN, int8_t, int, false, false>(x, taps, scale, out,
                                                        p, st);
  if (kind != TAPS) return static_cast<int>(cudaErrorInvalidValue);
  if (!dp2a) {
    if (!fi && ib == 1 && ob == 1)
      return launch<TAPS, int8_t, int8_t, false, false>(x, taps, scale, out,
                                                        p, st);
    if (!fi && ib == 4 && ob == 4)
      return launch<TAPS, int, int, false, false>(x, taps, scale, out, p, st);
    if (!fi && ib == 1 && ob == 4)
      return launch<TAPS, int8_t, int, false, false>(x, taps, scale, out, p,
                                                     st);
    if (fi && ib == 1 && ob == 1)
      return launch<TAPS, int8_t, int8_t, true, false>(x, taps, scale, out,
                                                       p, st);
    if (fi && ib == 1 && ob == 4)
      return launch<TAPS, int8_t, int, true, false>(x, taps, scale, out, p,
                                                    st);
  } else if (fi && ib == 1 && ob == 2) {
    return launch<TAPS, int8_t, int16_t, true, true>(x, taps, scale, out, p,
                                                     st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
