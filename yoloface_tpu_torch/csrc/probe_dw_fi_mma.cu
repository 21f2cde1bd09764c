// The frame-innermost depthwise taps, R times, on the int8 tensor cores:
// the Hopper form of the dw16 probe (B9.4).
//
// Replaces, beside probe_dw.cu's one-thread-an-output form (kept as the
// probe's "(PR 7)" variants), the taps of tools/microbench.py::dw16_probe
// (:412, pallas_call :458): x int8 [SP, SP, C, N] (frames innermost, the
// TPU kernels' layout), taps int32 [9, C] (tap dy*3+dx major); the so x so
// outputs out[oy, ox, c, n] = sum_{r < R} sum_k x[oy + dy, ox + dx, c, n] *
// (tap k + r), int32 or the int32 sum truncated to int16 (which has the
// bits of int16 accumulators: int16 wrap is arithmetic mod 2**16).  Plain
// version: kernels/probes.py probe_dw_plain.
//
// What bounds it on the card: device-memory bytes.  At the probe's
// headline (C 40 at 14x14, N 32,768, R 16, int16 out) 335.5 MB in and
// 513.8 MB out take 0.2535 ms at 3.35 TB/s; its 37.0 G multiply-adds would
// take 1.10 ms on the CUDA cores (two operations each at 67 T/s), where the
// PR 7 form ran them: one thread an output, nine byte loads and, each
// repetition, five __dp2a and five __vadd2 for nine multiply-adds.  Here
// the tensor cores take them, 2 x 2 outputs (output rows oy, oy + 1 by
// pixels ox, ox + 1) a product on mma.sync.m16n8k16 s8 -> s32:
//  * a warp task is one channel, a pair of output rows and 64 frames; M
//    is the frames (row g of m-tile mt is the lane's frame 2mt, row g + 8
//    frame 2mt + 1; a lane's 8 frames are 8g..8g+7 of the task's, or for
//    int32 out 4g..4g+3 and 32 + 4g..+3, so that each 16-byte store of a
//    warp is 128 contiguous bytes: whole sectors);
//  * K is the four input rows the pair of output rows reads, at four
//    columns: lane t holds input row oy + t at columns ox..ox+3 (k 4t + i:
//    column ox + i), no padding.  Walking the rows, each lane loads two
//    new column words a pair of pixels and slides each frame's A word by
//    two bytes (12 prmt); the next kPairs pairs' loads are in flight while
//    this pair computes.  An input byte comes from device memory about
//    once: the warps of a block take consecutive pairs of output rows of
//    one channel and frame tile, which read the rows between them from L1;
//  * N is the outputs and the repetitions: column j of n-tile q is output
//    (oy + (j >> 2), ox + ((j >> 1) & 1)) and repetition 2q + (j & 1),
//    nonzero in the lanes of that output row's input rows only (lane t:
//    the taps (t - dr, 0..2) at bytes dp..dp+2, plus r), zero past R.  The
//    B fragments are built a warp task (one __vadd4 each) and R = 16 is
//    eight n-tiles accumulating into the same registers, so every
//    repetition's products are the tensor cores' (the repetitions are
//    never summed in closed form and the taps never summed first); past
//    16, eight more n-tiles a chunk;
//  * lane (g, t)'s accumulator columns 2t, 2t + 1 are one output,
//    (oy + (t >> 1), ox + (t & 1)), at both repetition parities: it adds
//    the two and stores its 8 frames (16 or 32 bytes), and no sum crosses
//    lanes.
// Forms the card ran first (PERF.md, B9.4): one output a product (K the
// nine taps of 16, N the repetitions, a six-shuffle reduce-scatter of the
// quad's columns) and one pixel pair (N two pixels by four repetitions,
// one shuffle exchange) were issue-bound at about 90 and 57 instructions
// an output.
// The s8 tensor cores need every tap plus r in [-128, 127]; the probe's
// taps are [-8, 8) plus r <= 15.  A warp task whose channel has a tap that
// does not fit runs an int32 body on the CUDA cores (R real passes of the
// nine multiply-adds, two frames a lane) in the same launch.  A frame
// count that is not a multiple of 8 (or a tensor not aligned) takes byte
// loads and element stores (kVec false).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 64;         // frames a warp task
// pairs of input columns a lane has in flight, blocks an SM the launch
// bound asks (80 registers a thread; at four blocks, 64, it spilled);
// ordering the tasks frame tile first (512 contiguous bytes a block, each
// input row read by tasks far apart) ran slower on the card
constexpr int kPairs = 3;
constexpr int kBlocks = 3;
constexpr int kTiles = 8;           // n-tiles of B in registers: R 16

struct Params {
  int n, sp, c, so, reps;           // x [sp, sp, c, n]; out [so, so, c, n]
  int tiles;                        // ceil(n / kFrames)
  int rows2;                        // ceil(so / 2): pairs of output rows
};

__device__ __forceinline__ void mma_k16(int (&d)[4], unsigned a0, unsigned a1,
                                        unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ int opaque(int r) {
  asm volatile("" : "+r"(r));
  return r;
}

// a lane's 8 frames of a row (zero past n): fx..fx+3 in x and
// fy..fy+3 in y, fy = fx + 4 (one 8-byte load with kVec: n a multiple of
// 8) or fx + 32 (kSplit: two 4-byte loads), or bytes
template <bool kVec, bool kSplit>
__device__ __forceinline__ uint2 load_frames(const int8_t* row, int fx,
                                             int n) {
  const int fy = fx + (kSplit ? 32 : 4);
  if constexpr (kVec && !kSplit) {
    return fx < n ? __ldg(reinterpret_cast<const uint2*>(row + fx))
                  : make_uint2(0, 0);
  } else if constexpr (kVec) {
    return make_uint2(
        fx < n ? __ldg(reinterpret_cast<const unsigned*>(row + fx)) : 0u,
        fy < n ? __ldg(reinterpret_cast<const unsigned*>(row + fy)) : 0u);
  } else {
    unsigned v[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = (j < 4 ? fx : fy) + (j & 3);
      if (f < n)
        v[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[f]))
                     << (8 * (j & 3));
    }
    return make_uint2(v[0], v[1]);
  }
}

// the 8 frames of an output row that load_frames reads, v0..v3 at
// fx..fx+3 and v4..v7 at fy..: one 16-byte store (int16), or two 8-byte
// (int16, kSplit) or 16-byte (int32) stores, each a warp's 128 contiguous
// bytes (kVec: out 16-byte aligned), or elements
template <bool kVec, bool kSplit, typename OutT>
__device__ __forceinline__ void store8(OutT* row, int fx, int n, int v0,
                                       int v1, int v2, int v3, int v4,
                                       int v5, int v6, int v7) {
  const int fy = fx + (kSplit ? 32 : 4);
  auto pk = [](int lo, int hi) {
    return (static_cast<unsigned>(lo) & 0xFFFFu) |
           static_cast<unsigned>(hi) << 16;
  };
  if constexpr (kVec && !kSplit && sizeof(OutT) == 2) {
    if (fx < n)
      *reinterpret_cast<uint4*>(row + fx) =
          make_uint4(pk(v0, v1), pk(v2, v3), pk(v4, v5), pk(v6, v7));
  } else if constexpr (kVec && sizeof(OutT) == 2) {
    if (fx < n)
      *reinterpret_cast<uint2*>(row + fx) = make_uint2(pk(v0, v1),
                                                       pk(v2, v3));
    if (fy < n)
      *reinterpret_cast<uint2*>(row + fy) = make_uint2(pk(v4, v5),
                                                       pk(v6, v7));
  } else if constexpr (kVec) {
    if (fx < n) *reinterpret_cast<int4*>(row + fx) = make_int4(v0, v1, v2, v3);
    if (fy < n) *reinterpret_cast<int4*>(row + fy) = make_int4(v4, v5, v6, v7);
  } else {
    const int v[8] = {v0, v1, v2, v3, v4, v5, v6, v7};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = (j < 4 ? fx : fy) + (j & 3);
      if (f < n) row[f] = static_cast<OutT>(v[j]);
    }
  }
}

template <bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads, kBlocks)
    dw_fi_mma_kernel(const int8_t* __restrict__ x, const int* __restrict__ taps,
                     void* __restrict__ out_, Params p) {
  // int32 out: a lane's frames in two runs of four, 32 apart (kSplit), so
  // that each 16-byte store of a warp is 128 contiguous bytes
  constexpr bool kSplit = sizeof(OutT) == 4;
  OutT* const out = static_cast<OutT*>(out_);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n = p.n, reps = p.reps;
  const long long col = static_cast<long long>(p.c) * p.n;   // a column
  const long long row = col * p.sp, orow = col * p.so;       // rows
  const long long tasks = static_cast<long long>(p.tiles) * p.c * p.rows2;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  const int chunks = (reps + 2 * kTiles - 1) / (2 * kTiles);
  // the warps of a block take consecutive tasks: consecutive pairs of
  // output rows (the pair fastest) of one channel and frame tile, sharing
  // input rows
  for (long long task = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
       task < tasks; task += step) {
    const int oy = 2 * static_cast<int>(task % p.rows2);
    const long long rest = task / p.rows2;
    const int c = static_cast<int>(rest % p.c);
    const int f0 = static_cast<int>(rest / p.c) * kFrames;
    // the lane's 8 frames: fx..fx+3 and fx + 4 (kSplit: 32)..
    const int fx = f0 + (kSplit ? 4 : 8) * g;
    OutT* const op = out + oy * orow + static_cast<long long>(c) * n;
    // B column g is output (oy + dr, ox + dp) of the 2 x 2 outputs and
    // repetition parity g & 1; lane t is input row oy + t, which the output
    // row takes with its taps dy = t - dr
    const int dr = g >> 2, dp = (g >> 1) & 1, dy = t - dr;
    const bool has = dy >= 0 && dy < 3;
    int w[3] = {0, 0, 0};
    bool fits = true;
    if (has) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        w[i] = __ldg(taps + (3 * dy + i) * p.c + c);
        fits = fits && w[i] >= -128 && w[i] <= 128 - reps;
      }
    }
    if (__all_sync(0xFFFFFFFFu, fits)) {
      // B of n-tile q (repetitions 2q, 2q + 1): bytes dp..dp+2 of lane t
      // the taps (dy, 0..2) plus r = 2q + (g & 1), zero past R and where
      // the lane's row is not the column's; in registers for the task
      // (the asm keeps the compiler from rebuilding them every pair)
      const unsigned base = ((static_cast<unsigned>(w[0]) & 0xFFu) |
                             (static_cast<unsigned>(w[1]) & 0xFFu) << 8 |
                             (static_cast<unsigned>(w[2]) & 0xFFu) << 16)
                            << (8 * dp);
      const unsigned bm = has ? 0x00010101u << (8 * dp) : 0u;
      const int rg = g & 1;
      auto bfrag = [base, bm, reps, rg](int r0) -> unsigned {
        const int r = r0 + rg;
        return r < reps ? __vadd4(base, static_cast<unsigned>(r) * bm) : 0u;
      };
      unsigned b[kTiles];
#pragma unroll
      for (int q = 0; q < kTiles; ++q) b[q] = bfrag(2 * q);
#pragma unroll
      for (int q = 0; q < kTiles; q += 4)
        asm volatile("" : "+r"(b[q]), "+r"(b[q + 1]), "+r"(b[q + 2]),
                     "+r"(b[q + 3]));
      // lane (g, t): input row oy + t (zero past the frame: the last pair
      // of rows of an odd S), the lane's frames, column xc at xr + xc * col
      // (zero past the row: the last pair of pixels of an odd S)
      const int sp = p.sp;
      const int8_t* const xr =
          x + (oy + t) * row + static_cast<long long>(c) * n;
      const bool ld = oy + t < sp;
      auto column = [ld, n, fx, sp](const int8_t* at, int xc) -> uint2 {
        uint2 v = make_uint2(0, 0);
        if (ld && xc < sp) v = load_frames<kVec, kSplit>(at, fx, n);
        return v;
      };
      // a[j]: the A word of the lane's frame j (fx + j, then fx + 4 or 32
      // + j - 4): input columns ox..ox+3 in bytes 0..3
      unsigned a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = 0u;
      auto slide = [&a](uint2 u, uint2 v) {   // by two columns, u and v
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned cu = h ? u.y : u.x, cv = h ? v.y : v.x;
          const unsigned p01 = __byte_perm(cu, cv, 0x5140);   // frames 0, 1
          const unsigned p23 = __byte_perm(cu, cv, 0x7362);   // frames 2, 3
          a[4 * h] = __byte_perm(a[4 * h], p01, 0x5432);
          a[4 * h + 1] = __byte_perm(a[4 * h + 1], p01, 0x7632);
          a[4 * h + 2] = __byte_perm(a[4 * h + 2], p23, 0x5432);
          a[4 * h + 3] = __byte_perm(a[4 * h + 3], p23, 0x7632);
        }
      };
      slide(column(xr, 0), column(xr + col, 1));
      // u[d], v[d]: input columns ox + 2, ox + 3 of the pairs at ox = 2d
      // mod 2 kPairs, loaded kPairs pairs ahead of their use (at: column
      // ox + 2 kPairs + 2, the next load's)
      uint2 u[kPairs], v[kPairs];
#pragma unroll
      for (int d = 0; d < kPairs; ++d) {
        u[d] = column(xr + (2 + 2 * d) * col, 2 + 2 * d);
        v[d] = column(xr + (3 + 2 * d) * col, 3 + 2 * d);
      }
      const int8_t* at = xr + (2 + 2 * kPairs) * col;
      // lane (g, t)'s accumulator columns 2t, 2t + 1 are output
      // (oy + (t >> 1), ox + (t & 1)) at both repetition parities
      const bool row_in = oy + (t >> 1) < p.so;
      OutT* st = op + (t >> 1) * orow + (t & 1) * col;
      for (int ox0 = 0; ox0 < p.so; ox0 += 2 * kPairs) {
#pragma unroll
        for (int d = 0; d < kPairs; ++d) {
          const int ox = ox0 + 2 * d;
          if (ox >= p.so) break;
          slide(u[d], v[d]);
          if (ox + 2 * kPairs < p.so) {
            u[d] = column(at, ox + 2 * kPairs + 2);
            v[d] = column(at + col, ox + 2 * kPairs + 3);
          }
          at += 2 * col;
          int acc[4][4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][e] = 0;
#pragma unroll
          for (int q = 0; q < kTiles; ++q)
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
              mma_k16(acc[mt], a[2 * mt], a[2 * mt + 1], b[q]);
          for (int ch = 1; ch < chunks; ++ch) {   // R past 2 kTiles
#pragma unroll
            for (int q = 0; q < kTiles; ++q) {
              const unsigned bq = bfrag(2 * (kTiles * ch + q));
#pragma unroll
              for (int mt = 0; mt < 4; ++mt)
                mma_k16(acc[mt], a[2 * mt], a[2 * mt + 1], bq);
            }
          }
          // c0 + c1: the lane's frame 2mt, c2 + c3: frame 2mt + 1
          if (row_in && ox + (t & 1) < p.so)
            store8<kVec, kSplit>(st, fx, n, acc[0][0] + acc[0][1],
                         acc[0][2] + acc[0][3], acc[1][0] + acc[1][1],
                         acc[1][2] + acc[1][3], acc[2][0] + acc[2][1],
                         acc[2][2] + acc[2][3], acc[3][0] + acc[3][1],
                         acc[3][2] + acc[3][3]);
          st += 2 * col;
        }
      }
    } else {
      // a tap past int8 less R - 1: the int32 body, R passes of the nine
      // multiply-adds (mod 2**32, as the int32 sums wrap), r opaque so the
      // passes are neither hoisted nor summed in closed form; frames
      // f0 + 2 lane, +1 of the task's output rows
      const int fs = f0 + 2 * lane;
      int wv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wv[k] = __ldg(taps + k * p.c + c);
      for (int r2 = 0; r2 < 2 && oy + r2 < p.so; ++r2) {
        const int8_t* const xb =
            x + (oy + r2) * row + static_cast<long long>(c) * n;
        for (int ox = 0; ox < p.so; ++ox) {
          int x0[9], x1[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const int8_t* q = xb + (k / 3) * row + (ox + k % 3) * col;
            x0[k] = fs < n ? q[fs] : 0;
            x1[k] = fs + 1 < n ? q[fs + 1] : 0;
          }
          unsigned s0 = 0u, s1 = 0u;
          for (int r = 0; r < reps; ++r) {
            const unsigned rr = static_cast<unsigned>(opaque(r));
#pragma unroll
            for (int k = 0; k < 9; ++k) {
              const unsigned wr = static_cast<unsigned>(wv[k]) + rr;
              s0 += static_cast<unsigned>(x0[k]) * wr;
              s1 += static_cast<unsigned>(x1[k]) * wr;
            }
          }
          OutT* const o = op + r2 * orow + ox * col;
          if (fs < n) o[fs] = static_cast<OutT>(static_cast<int>(s0));
          if (fs + 1 < n) o[fs + 1] = static_cast<OutT>(static_cast<int>(s1));
        }
      }
    }
  }
}

using Kernel = void (*)(const int8_t*, const int*, void*, Params);

Kernel instantiation(int i16, int vec) {
  if (i16) return vec ? dw_fi_mma_kernel<true, int16_t>
                      : dw_fi_mma_kernel<false, int16_t>;
  return vec ? dw_fi_mma_kernel<true, int> : dw_fi_mma_kernel<false, int>;
}

}  // namespace

// params: n frames, sp, c, so (so + 2 <= sp: offsets, stride 1, no
// border), reps (>= 1), i16 (int16 out, else int32), vec (n a multiple of
// 8, x and out 8-byte aligned: 8-byte loads, 4- or 8-byte stores).  x int8
// [sp, sp, c, n], taps int32 [9, c], out [so, so, c, n].
extern "C" int yf_probe_dw_fi_mma(const void* x, const void* taps, void* out,
                                  const int* params, void* stream) {
  Params p;
  p.n = params[0]; p.sp = params[1]; p.c = params[2]; p.so = params[3];
  p.reps = params[4];
  const int i16 = params[5], vec = params[6];
  if (p.n < 1 || p.c < 1 || p.so < 1 || p.so + 2 > p.sp || p.reps < 1 ||
      static_cast<long long>(p.sp) * p.sp * p.c * p.n >= (1LL << 31) ||
      (vec && ((p.n & 7) || (reinterpret_cast<uintptr_t>(x) & 7) ||
               (reinterpret_cast<uintptr_t>(out) & 15))))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k = instantiation(i16, vec);
  p.tiles = (p.n + kFrames - 1) / kFrames;
  p.rows2 = (p.so + 1) / 2;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tasks = static_cast<long long>(p.tiles) * p.c * p.rows2;
  const long long grid = min((tasks + kWarps - 1) / kWarps,
                             static_cast<long long>(sms) * per_sm);
  k<<<static_cast<unsigned>(grid), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(taps), out, p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local bytes a thread, static shared bytes
// and blocks an SM of the instantiation for int16 (i16) or int32 out, with
// 8-byte (vec) or byte accesses.
extern "C" int yf_probe_dw_fi_mma_attrs(int i16, int vec, int* out) {
  Kernel k = instantiation(i16, vec);
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
