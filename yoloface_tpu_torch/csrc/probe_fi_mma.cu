// The frame-innermost 1x1 on the int8 tensor cores: the Hopper form of
// the whcn probe's 1x1 (B9.2).
//
// Replaces, beside probe_conv.cu's FI1 / FI4 (kept as the probe's "(PR 7)"
// variants), the 1x1 of tools/microbench.py::whcn_probe (:131,
// pallas_call :159): x int8 [P, K, N] (pixel, channel, frame: frames
// innermost, the TPU kernels' layout), w int8 [Nout, K]; channel co <
// Nout of the output is clip(acc >> 7) (SHIFT, with the channels Nout..K-1
// copied from x) or int8(acc) (WRAP), acc = sum_k w[co, k] * x[p, k, n].
// Plain version: kernels/probes.py probe_conv_plain.
//
// What bounds it on the card: device-memory bytes.  At K 36, Nout 24 the
// MACs take 0.17 ms on the CUDA cores' integer pipes, above the bytes'
// 0.138 ms; on the int8 tensor cores well under 0.01 ms.  The PR 7 form
// ran one thread a (pixel, channel, 4 frames) on the CUDA cores and
// re-read a pixel's 36 rows for each of its 24 output channels.  Here each
// pixel's product is OUT^T[n, co] = X^T[n, k] W^T[k, co], the frames as
// the product's M, on mma.sync.m16n8k32 s8 -> s32:
//  * a warp takes a task of one pixel and 64 frames; lane (g, t) (g =
//    lane / 4, t = lane % 4) reads 8 bytes (frames 8g..8g+7) of each of its
//    K rows (rows 32s + 16h + 4t + i of k-step s, half h, i < 4; zero past
//    K), so each input byte is read once and a warp's load covers 64
//    contiguous bytes of a row;
//  * a 4x4 byte transpose (prmt) turns four rows' words into four frames'
//    k-major words: the A fragments, row g of m-tile mt frame 8g + 2mt and
//    row g + 8 frame 8g + 2mt + 1 (tests/test_torch_probes.py holds this
//    order as numpy index maps and multiplies through them);
//  * W^T's B fragments (co = 8nt + g, K zero-padded to 64 and Nout to a
//    multiple of 8: zero products keep the sums exact) sit in registers for
//    the whole launch;
//  * the accumulators of lane (g, t) are output channels 8nt + 2t + e of
//    frames 8g..8g+7: one 8-byte store a channel, and a warp's store covers
//    64 contiguous bytes of a row; SHIFT's copied rows leave from the loaded
//    words, by the lane that read them.
// A frame count that is not a multiple of 8 (or an unaligned tensor) takes
// the same body with byte loads and stores (kVec false).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Epi { SHIFT = 1, WRAP = 2 };   // probe_conv's codes

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 64;         // frames a warp task

// blocks an SM the launch bound asks: two up to three n-tiles (128
// registers a thread); at four, two spilled, so one
constexpr int blocks_for(int nt) { return nt <= 3 ? 2 : 1; }

struct Params {
  int m, k, nout, ldo, n, epi;
  int tiles;                        // ceil(n / kFrames)
};

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows -> columns of a 4x4 byte block: w[i] byte j is row i, frame j in;
// w[j] byte i out
__device__ __forceinline__ void transpose4(unsigned (&w)[4]) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);   // a0 b0 a1 b1
  const unsigned t1 = __byte_perm(w[0], w[1], 0x7362);   // a2 b2 a3 b3
  const unsigned t2 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);                    // a0 b0 c0 d0
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// frames f..f+7 of a row (zero past n): one 8-byte load (kVec: n a
// multiple of 8, so all eight or none are there) or bytes
template <bool kVec>
__device__ __forceinline__ uint2 load8(const int8_t* row, int f, int n) {
  if constexpr (kVec) {
    return f < n ? __ldg(reinterpret_cast<const uint2*>(row + f))
                 : make_uint2(0, 0);
  } else {
    unsigned v[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (f + j < n)
        v[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[f + j]))
                     << (8 * (j & 3));
    return make_uint2(v[0], v[1]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store8(int8_t* row, int f, int n, uint2 v) {
  if constexpr (kVec) {
    if (f < n) *reinterpret_cast<uint2*>(row + f) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (f + j < n)
        row[f + j] = static_cast<int8_t>((j < 4 ? v.x : v.y) >> (8 * (j & 3)));
  }
}

__device__ __forceinline__ unsigned finish(int acc, int epi) {
  const int v = epi == SHIFT ? min(max(acc >> 7, -128), 127) : acc;
  return static_cast<unsigned>(static_cast<uint8_t>(v));
}

template <int kNT, bool kVec>
__global__ void __launch_bounds__(kThreads, blocks_for(kNT))
    fi_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  int8_t* __restrict__ out, Params p) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // W^T's B fragments: k-step s, n-tile nt, half h: w[8nt + g][32s + 16h
  // + 4t + i] as byte i, zero past Nout and K
  unsigned bw[2][kNT][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = 8 * nt + g, k0 = 32 * s + 16 * h + 4 * t;
        unsigned v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (co < p.nout && k0 + i < p.k)
            v |= static_cast<unsigned>(
                     static_cast<uint8_t>(__ldg(w + co * p.k + k0 + i)))
                 << (8 * i);
        bw[s][nt][h] = v;
      }
  const int steps = p.k > 32 ? 2 : 1;
  const long long tasks = static_cast<long long>(p.m) * p.tiles;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long task = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
       task < tasks; task += stride) {
    const int pix = static_cast<int>(task / p.tiles);
    const int f = static_cast<int>(task - static_cast<long long>(pix) *
                                              p.tiles) * kFrames + 8 * g;
    const int8_t* xp = x + static_cast<long long>(pix) * p.k * p.n;
    int8_t* op = out + static_cast<long long>(pix) * p.ldo * p.n;
    int acc[4][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    // every load of the task first, so all are in flight at once:
    // lo / hi [step][half][row i] hold frames f..f+3 and f+4..f+7 of row
    // 32 step + 16 half + 4t + i
    unsigned lo[2][2][4], hi[2][2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 32 * s + 16 * h + 4 * t + i;
          uint2 v = make_uint2(0, 0);
          if (r < p.k)
            v = load8<kVec>(xp + static_cast<long long>(r) * p.n, f, p.n);
          lo[s][h][i] = v.x;
          hi[s][h][i] = v.y;
        }
    if (p.epi == SHIFT) {           // the copied channels, from the lane
#pragma unroll                       // that read them
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 32 * s + 16 * h + 4 * t + i;
            if (r >= p.nout && r < p.k)
              store8<kVec>(op + static_cast<long long>(r) * p.n, f, p.n,
                           make_uint2(lo[s][h][i], hi[s][h][i]));
          }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s >= steps) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        transpose4(lo[s][h]);       // lo[s][h][j]: frame f + j, k-major
        transpose4(hi[s][h]);       // hi[s][h][j]: frame f + 4 + j
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // m-tile mt: row g is frame f + 2mt, row g + 8 frame f + 2mt + 1
        const unsigned(&a)[2][4] = mt < 2 ? lo[s] : hi[s];
        const int j = 2 * (mt & 1);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_s8(acc[mt][nt], a[0][j], a[0][j + 1], a[1][j], a[1][j + 1],
                 bw[s][nt][0], bw[s][nt][1]);
      }
    }
    // c0 / c1: frame f + 2mt, channels 8nt + 2t, +1; c2 / c3: frame
    // f + 2mt + 1
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = 8 * nt + 2 * t + e;
        if (co >= p.nout) continue;
        unsigned v[2] = {0u, 0u};
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          v[mt >> 1] |= (finish(acc[mt][nt][e], p.epi) |
                         finish(acc[mt][nt][2 + e], p.epi) << 8)
                        << (16 * (mt & 1));
        store8<kVec>(op + static_cast<long long>(co) * p.n, f, p.n,
                     make_uint2(v[0], v[1]));
      }
  }
}

using Kernel = void (*)(const int8_t*, const int8_t*, int8_t*, Params);

template <bool kVec>
Kernel by_tiles(int nt) {
  switch (nt) {
    case 1: return fi_mma_kernel<1, kVec>;
    case 2: return fi_mma_kernel<2, kVec>;
    case 3: return fi_mma_kernel<3, kVec>;
    case 4: return fi_mma_kernel<4, kVec>;
    default: return nullptr;
  }
}

Kernel instantiation(int nt, int vec) {
  return vec ? by_tiles<true>(nt) : by_tiles<false>(nt);
}

}  // namespace

// params: m pixels, k, nout, ldo (k for SHIFT, nout for WRAP), n frames,
// epi (1 SHIFT, 2 WRAP), vec (n a multiple of 8 and every tensor 8-byte
// aligned: 8-byte loads and stores).  x int8 [m, k, n], w int8 [nout, k],
// out int8 [m, ldo, n]; k <= 64, nout <= 32.
extern "C" int yf_probe_fi_mma(const void* x, const void* w, void* out,
                               const int* params, void* stream) {
  Params p;
  p.m = params[0]; p.k = params[1]; p.nout = params[2]; p.ldo = params[3];
  p.n = params[4]; p.epi = params[5];
  const int vec = params[6];
  if (p.m < 1 || p.k < 1 || p.k > 64 || p.nout < 1 || p.nout > 32 ||
      p.n < 1 || (p.epi != SHIFT && p.epi != WRAP) ||
      p.ldo != (p.epi == SHIFT ? p.k : p.nout) ||
      (p.epi == SHIFT && p.nout > p.k) ||
      static_cast<long long>(p.m) * p.n * p.k >= (1LL << 31) ||
      (vec && ((p.n & 7) ||
               ((reinterpret_cast<uintptr_t>(x) |
                 reinterpret_cast<uintptr_t>(out)) & 7))))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k = instantiation((p.nout + 7) / 8, vec);
  p.tiles = (p.n + kFrames - 1) / kFrames;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tasks = static_cast<long long>(p.m) * p.tiles;
  const long long grid = min((tasks + kWarps - 1) / kWarps,
                             static_cast<long long>(sms) * per_sm);
  k<<<static_cast<unsigned>(grid), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(static_cast<const int8_t*>(x),
                                           static_cast<const int8_t*>(w),
                                           static_cast<int8_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local bytes a thread, static shared bytes
// and blocks an SM of the instantiation for `nt` n-tiles of 8 output
// channels, 8-byte (vec) or byte accesses.
extern "C" int yf_probe_fi_mma_attrs(int nt, int vec, int* out) {
  Kernel k = instantiation(nt, vec);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}
