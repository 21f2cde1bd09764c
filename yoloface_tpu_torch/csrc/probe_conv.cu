// The 1x1 convolutions of the tools/ probes: the CUDA-core loop against
// __dp4a and the int8 (and bf16) tensor cores.
//
// Replaces the dot kernels of tools/microbench.py: conv1x1_probe (:23, a
// 1x1 conv of int8 channels, clip(acc >> 7) on the first Co channels and
// the rest copied), whcn_probe (:131, the same in the frame-innermost
// [S,S,C,N] layout), inkernel_probe (:264, the dot repeated R times on
// chip, weights plus r, int32 sums) and packdot_probe (:496, one dot a
// position against P positions packed block-diagonally), and of
// tools/probe448_micro.py main (:20, probes B and C: 8x8 dots a position,
// int8(acc) wrapping) and main2 (:120, B2 and D: the same walked by one
// block a frame or by a grid of chunks).  Plain versions:
// kernels/probes.py.
//
// NHWC: the input is a row-major [M, K] int8 matrix (M positions, K
// channels), the weights [Nout, K]; a 1x1 conv is OUT[m, n] = sum_k A[m, k]
// * W[n, k], and packing P positions block-diagonally is the same product
// on the [M / P, P * K] view with [P * Nout, P * K] weights.  Variants:
//  * LOOP: the arena's conv_op loop (csrc/arena_ops.cuh), one thread an
//    output with the channel fastest, its input row and its own weight row
//    read byte by byte from device memory (weights through __ldg);
//  * IMAD, DP4A, MMA8, MMA16: a block of 128 threads stages a 64-row tile
//    of A and 64 weight rows in shared memory, K zero-padded to a multiple
//    of 32 (the padding of the tile is written as zeros every time it is
//    staged), then computes the 64 x 64 outputs: IMAD and DP4A as a 4 x 8
//    register tile a thread (byte multiply-adds, or __dp4a on 4 bytes);
//    MMA8 with mma.sync.m16n8k32 s8 -> s32, a warp 16 rows by 8 n-tiles;
//    MMA16 the same on bf16 copies of the tiles with m16n8k16 -> f32
//    (exact while the sums stay integers below 2**24).  A block walks `tiles_per_block` row
//    tiles, reusing its staged weights; blockIdx.y picks 64 of Nout.
// Frame innermost (FI1, FI4): x [P, K, N] with the frames innermost, one
// thread an output (pixel, channel, frame), or four frames as a char4, so a
// warp's lanes are 32 frames and every lane reads the same weight.  The
// whcn probe's headline runs the same 1x1 on the int8 tensor cores
// (probe_fi_mma.cu); FI4 is its "(PR 7)" form.
//
// R repetitions (the in-kernel form): the smem variants add 1 to every
// staged weight byte between repetitions (and subtract R - 1 after), so
// repetition r multiplies by W + r and the inner loops stay pure
// multiply-adds; LOOP and FI add r, passed through an empty asm, to each
// weight they read.  W + r wraps to int8 in every variant, as the JAX
// probes' int8 `w + r` does.  The padding stays harmless: the A tile's
// padded columns are zero.  Epilogues: RAW int32 sums; SHIFT, int8 clip(acc >> 7)
// on the first Nout of ldo = K columns and the input copied into the rest;
// WRAP, int8(acc) as two's complement truncation (static_cast), as the
// JAX probes' astype(int8) of an int32 wraps.
//
// What bounds it on the card: the operations at the probes' small K (4-40)
// once R repeats the work on chip, bytes at R = 1.  The int8 tensor cores'
// 1,979 TOPS against the CUDA cores' integer pipes is the question the
// probes ask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Variant { LOOP = 0, IMAD = 1, DP4A = 2, MMA8 = 3, MMA16 = 4, FI1 = 5,
               FI4 = 6 };
enum Epi { RAW = 0, SHIFT = 1, WRAP = 2 };

constexpr int TM = 64, TN = 64, THREADS = 128;

struct ConvParams {
  int epi, m, k, nout, ldo, n, reps, tiles_per_block;
};

__device__ __forceinline__ int opaque(int r) {
  asm volatile("" : "+r"(r));
  return r;
}

// a weight plus r, wrapped to int8 as the JAX probes' int8 `w + r` is
__device__ __forceinline__ int plus(int8_t w, int r) {
  return static_cast<int8_t>(w + r);
}

template <typename OutT>
__device__ __forceinline__ OutT finish(int acc, int epi) {
  if constexpr (sizeof(OutT) == 4) {
    return acc;
  } else {
    if (epi == SHIFT) return static_cast<int8_t>(min(max(acc >> 7, -128), 127));
    return static_cast<int8_t>(acc);      // WRAP
  }
}

// ------------------------------------------------------------------ LOOP
template <typename OutT>
__global__ void __launch_bounds__(256)
    conv_loop(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
              OutT* __restrict__ out, ConvParams p) {
  const int total = p.m * p.ldo;        // below 2**31: 32-bit index math
  const int step = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += step) {
    const int col = e % p.ldo;
    const int8_t* ar = a + (e / p.ldo) * p.k;
    if (col >= p.nout) {             // SHIFT: the channels passed through
      out[e] = static_cast<OutT>(ar[col]);
      continue;
    }
    const int8_t* wr = w + col * p.k;
    int acc = 0;
    if (p.reps == 1) {               // conv_op's body
      for (int k = 0; k < p.k; ++k)
        acc += static_cast<int>(ar[k]) * static_cast<int>(__ldg(wr + k));
    } else {
      for (int r = 0; r < p.reps; ++r) {
        const int rr = opaque(r);
        for (int k = 0; k < p.k; ++k)
          acc += static_cast<int>(ar[k]) * plus(__ldg(wr + k), rr);
      }
    }
    out[e] = finish<OutT>(acc, p.epi);
  }
}

// ------------------------------------------------- FI1 / FI4 (frames inner)
template <bool kQuad, typename OutT>
__global__ void __launch_bounds__(256)
    conv_fi(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            OutT* __restrict__ out, ConvParams p) {
  const int nq = kQuad ? p.n / 4 : p.n;
  const int total = p.m * p.ldo * nq;   // below 2**31: 32-bit index math
  const int step = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += step) {
    const int f = (e % nq) * (kQuad ? 4 : 1);
    const int q = e / nq;
    const int col = q % p.ldo;
    const int pix = q / p.ldo;
    const int8_t* xp = x + pix * p.k * p.n + f;
    OutT* op = out + (pix * p.ldo + col) * p.n + f;
    const int8_t* wr = w + col * p.k;
    if constexpr (!kQuad) {
      if (col >= p.nout) {
        *op = static_cast<OutT>(xp[col * p.n]);
        continue;
      }
      int acc = 0;
      for (int r = 0; r < p.reps; ++r) {
        const int rr = opaque(r);
        for (int k = 0; k < p.k; ++k)
          acc += static_cast<int>(xp[k * p.n]) * plus(__ldg(wr + k), rr);
      }
      *op = finish<OutT>(acc, p.epi);
    } else {
      if (col >= p.nout) {           // SHIFT only: int8 out
        *reinterpret_cast<char4*>(op) =
            *reinterpret_cast<const char4*>(xp + col * p.n);
        continue;
      }
      int acc[4] = {0, 0, 0, 0};
      for (int r = 0; r < p.reps; ++r) {
        const int rr = opaque(r);
        for (int k = 0; k < p.k; ++k) {
          const char4 v = *reinterpret_cast<const char4*>(xp + k * p.n);
          const int wv = plus(__ldg(wr + k), rr);
          acc[0] += v.x * wv;
          acc[1] += v.y * wv;
          acc[2] += v.z * wv;
          acc[3] += v.w * wv;
        }
      }
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<int4*>(op) = make_int4(acc[0], acc[1], acc[2],
                                                 acc[3]);
      } else {
        *reinterpret_cast<char4*>(op) = make_char4(
            finish<OutT>(acc[0], p.epi), finish<OutT>(acc[1], p.epi),
            finish<OutT>(acc[2], p.epi), finish<OutT>(acc[3], p.epi));
      }
    }
  }
}

// ------------------------------------------- IMAD / DP4A / MMA8 / MMA16
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory tiles: a row of `lds` elements (K padded to kp, plus a skew
// that spreads a warp's rows over the banks).
template <int kV>
struct Tile {
  using T = typename std::conditional<kV == MMA16, __nv_bfloat16,
                                      int8_t>::type;
  static constexpr int kSkew = kV == MMA8 ? 16 : kV == MMA16 ? 8 : 4;
};

// rows [r0, r0 + TM) of the [rows, k] int8 matrix src into the tile,
// zero-padded to kp columns and past the last row.
template <int kV>
__device__ void stage(typename Tile<kV>::T* t, const int8_t* __restrict__ src,
                      long long r0, int rows, int k, int kp, int lds) {
  using T = typename Tile<kV>::T;
  const T zero = T(0.0f);
  const long long avail = rows - r0;
  const int nr = avail < TM ? static_cast<int>(avail) : TM;
  bool words = false;
  if constexpr (kV != MMA16) {
    if ((k & 3) == 0) {                  // 4-byte moves, a row's words
      words = true;
      const int kw = k >> 2;
      const unsigned* s = reinterpret_cast<const unsigned*>(src + r0 * k);
      for (int i = threadIdx.x; i < nr * kw; i += THREADS) {
        const int r = i / kw, c = (i - r * kw) << 2;
        *reinterpret_cast<unsigned*>(t + r * lds + c) = __ldg(s + i);
      }
    }
  }
  if (!words) {
    for (int i = threadIdx.x; i < nr * k; i += THREADS) {
      const int r = i / k, c = i - r * k;
      const int8_t v = src[(r0 + r) * k + c];
      if constexpr (kV == MMA16) t[r * lds + c] = __float2bfloat16(float(v));
      else t[r * lds + c] = v;
    }
  }
  const int pad = kp - k;                 // the padding, zeroed every time
  for (int i = threadIdx.x; i < TM * pad; i += THREADS) {
    const int r = i / pad, c = k + (i - r * pad);
    t[r * lds + c] = zero;
  }
  for (int i = threadIdx.x; i < (TM - nr) * kp; i += THREADS) {
    const int r = nr + i / kp, c = i % kp;
    t[r * lds + c] = zero;
  }
}

// add `by` to every weight of the tile, wrapped to int8 (per byte, mod
// 256; the bf16 copies of the bytes likewise, exact on these integers)
template <int kV>
__device__ void bump(typename Tile<kV>::T* t, int lds, int by) {
  if constexpr (kV == MMA16) {
    for (int i = threadIdx.x; i < TN * lds; i += THREADS) {
      float v = __bfloat162float(t[i]) + float(by);
      v -= 256.0f * floorf((v + 128.0f) * (1.0f / 256.0f));
      t[i] = __float2bfloat16(v);
    }
  } else {
    unsigned* u = reinterpret_cast<unsigned*>(t);
    const unsigned d = (static_cast<unsigned>(by) & 0xFFu) * 0x01010101u;
    for (int i = threadIdx.x; i < TN * lds / 4; i += THREADS)
      u[i] = __vadd4(u[i], d);
  }
}

template <int kV, typename OutT>
__global__ void __launch_bounds__(THREADS)
    conv_tile(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
              OutT* __restrict__ out, ConvParams p, int kp, int lds) {
  using T = typename Tile<kV>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sB = reinterpret_cast<T*>(smem);
  T* sA = sB + TN * lds;
  int* sOut = reinterpret_cast<int*>(sA + TM * lds);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * TN;
  stage<kV>(sB, w, n0, p.nout, p.k, kp, lds);
  const long long tiles = (static_cast<long long>(p.m) + TM - 1) / TM;
  for (int it = 0; it < p.tiles_per_block; ++it) {
    const long long tile =
        static_cast<long long>(blockIdx.x) * p.tiles_per_block + it;
    if (tile >= tiles) break;
    const long long m0 = tile * TM;
    __syncthreads();                     // sA and sOut free again
    stage<kV>(sA, a, m0, p.m, p.k, kp, lds);
    __syncthreads();
    const int nb = min(TN, p.nout - n0);      // the live columns
    if constexpr (kV == IMAD || kV == DP4A) {
      const int r0 = (tid & 15) * 4, c0 = (tid >> 4) * 8;
      const bool live = c0 < nb;              // whole warps past Nout idle
      int acc[4][8] = {};
      for (int r = 0; r < p.reps; ++r) {
        if (r > 0) {
          __syncthreads();
          bump<kV>(sB, lds, 1);
          __syncthreads();
        }
        if (!live) continue;
        if constexpr (kV == IMAD) {
          for (int k = 0; k < p.k; ++k) {
            int av[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = sA[(r0 + i) * lds + k];
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = sB[(c0 + j) * lds + k];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
          }
        } else {
          for (int k = 0; k < kp; k += 4) {
            int av[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              av[i] = *reinterpret_cast<const int*>(sA + (r0 + i) * lds + k);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              bv[j] = *reinterpret_cast<const int*>(sB + (c0 + j) * lds + k);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sOut[(r0 + i) * TN + c0 + j] = acc[i][j];
    } else {                                  // MMA8 / MMA16
      const int warp = tid >> 5, lane = tid & 31;
      const int g = lane >> 2, tq = lane & 3;
      const int ra = (warp * 16 + g) * lds;
      constexpr int kStep = kV == MMA8 ? 32 : 16;
      constexpr int kHalf = kStep / 2;        // the second k half a register
      constexpr int kLane = kV == MMA8 ? 4 : 2;   // elements a register
      using Acc = typename std::conditional<kV == MMA8, int, float>::type;
      Acc acc[8][4] = {};
      for (int r = 0; r < p.reps; ++r) {
        if (r > 0) {
          __syncthreads();
          bump<kV>(sB, lds, 1);
          __syncthreads();
        }
        for (int k = 0; k < kp; k += kStep) {
          const int ca = k + tq * kLane;
          const unsigned af[4] = {
              *reinterpret_cast<const unsigned*>(sA + ra + ca),
              *reinterpret_cast<const unsigned*>(sA + ra + 8 * lds + ca),
              *reinterpret_cast<const unsigned*>(sA + ra + ca + kHalf),
              *reinterpret_cast<const unsigned*>(sA + ra + 8 * lds + ca +
                                                 kHalf)};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (8 * j >= nb) break;             // n-tiles past Nout
            const T* bp = sB + (8 * j + g) * lds + ca;
            const unsigned b0 = *reinterpret_cast<const unsigned*>(bp);
            const unsigned b1 = *reinterpret_cast<const unsigned*>(bp + kHalf);
            if constexpr (kV == MMA8) mma_s8(acc[j], af, b0, b1);
            else mma_bf16(acc[j], af, b0, b1);
          }
        }
      }
      const int row = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * tq;
        sOut[row * TN + col] = static_cast<int>(acc[j][0]);
        sOut[row * TN + col + 1] = static_cast<int>(acc[j][1]);
        sOut[(row + 8) * TN + col] = static_cast<int>(acc[j][2]);
        sOut[(row + 8) * TN + col + 1] = static_cast<int>(acc[j][3]);
      }
    }
    if (p.reps > 1) {                         // the weights back to W
      __syncthreads();
      bump<kV>(sB, lds, -(p.reps - 1));
    }
    __syncthreads();
    for (int i = tid; i < TM * nb; i += THREADS) {
      const int r = i / nb, c = i - r * nb;
      if (m0 + r < p.m)
        out[(m0 + r) * p.ldo + n0 + c] = finish<OutT>(sOut[r * TN + c], p.epi);
    }
    const int rest = p.ldo - p.nout;   // SHIFT: channels copied from the tile
    if (blockIdx.y == 0 && rest > 0) {
      for (int i = tid; i < TM * rest; i += THREADS) {
        const int r = i / rest, c = p.nout + (i - r * rest);
        if (m0 + r < p.m)
          out[(m0 + r) * p.ldo + c] =
              static_cast<OutT>(static_cast<float>(sA[r * lds + c]));
      }
    }
  }
}

template <int kV, typename OutT>
int launch_tile(const void* a, const void* w, void* out, const ConvParams& p,
                int smem_limit, cudaStream_t stream) {
  using T = typename Tile<kV>::T;
  const int kp = (p.k + 31) / 32 * 32;
  const int lds = kp + Tile<kV>::kSkew;
  const int smem = static_cast<int>(2 * TM * lds * sizeof(T)) + TM * TN * 4;
  if (smem > smem_limit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_tile<kV, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (static_cast<long long>(p.m) + TM - 1) / TM;
  const long long gx = (tiles + p.tiles_per_block - 1) / p.tiles_per_block;
  const int gy = (p.nout + TN - 1) / TN;
  if (gx > 0x7FFFFFFF || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  conv_tile<kV, OutT><<<dim3(static_cast<unsigned>(gx), gy), THREADS, smem,
                        stream>>>(static_cast<const int8_t*>(a),
                                  static_cast<const int8_t*>(w),
                                  static_cast<OutT*>(out), p, kp, lds);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch(int variant, const void* a, const void* w, void* out,
             const ConvParams& p, cudaStream_t st) {
  const int smem_limit = 232448;
  auto grid = [](long long total) {
    long long b = (total + 255) / 256;
    if (b > 132 * 32) b = 132 * 32;
    return static_cast<unsigned>(b < 1 ? 1 : b);
  };
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* w8 = static_cast<const int8_t*>(w);
  auto* o = static_cast<OutT*>(out);
  switch (variant) {
    case LOOP:
      conv_loop<OutT><<<grid(static_cast<long long>(p.m) * p.ldo), 256, 0,
                        st>>>(a8, w8, o, p);
      return static_cast<int>(cudaGetLastError());
    case FI1:
      conv_fi<false, OutT><<<grid(static_cast<long long>(p.m) * p.ldo * p.n),
                             256, 0, st>>>(a8, w8, o, p);
      return static_cast<int>(cudaGetLastError());
    case FI4:
      conv_fi<true, OutT><<<grid(static_cast<long long>(p.m) * p.ldo * p.n /
                                 4),
                            256, 0, st>>>(a8, w8, o, p);
      return static_cast<int>(cudaGetLastError());
    case IMAD: return launch_tile<IMAD, OutT>(a, w, out, p, smem_limit, st);
    case DP4A: return launch_tile<DP4A, OutT>(a, w, out, p, smem_limit, st);
    case MMA8: return launch_tile<MMA8, OutT>(a, w, out, p, smem_limit, st);
    case MMA16: return launch_tile<MMA16, OutT>(a, w, out, p, smem_limit, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// params: variant, epi, m, k, nout, ldo, n, reps, tiles_per_block.  NHWC
// variants: a int8 [m, k], w int8 [nout, k], out [m, ldo] (int32 for RAW,
// int8 otherwise).  FI1 / FI4: a int8 [m pixels, k, n frames], out [m, ldo,
// n].  The caller checked shapes, alignment and the shared-memory size.
extern "C" int yf_probe_conv(const void* a, const void* w, void* out,
                             const int* params, void* stream) {
  ConvParams p;
  const int variant = params[0];
  p.epi = params[1]; p.m = params[2]; p.k = params[3]; p.nout = params[4];
  p.ldo = params[5]; p.n = params[6]; p.reps = params[7];
  p.tiles_per_block = params[8];
  if (p.m <= 0 || p.k <= 0 || p.nout <= 0 || p.ldo < p.nout || p.reps < 1 ||
      p.tiles_per_block < 1 || p.n < 1 ||
      static_cast<long long>(p.m) * p.n * (p.k > p.ldo ? p.k : p.ldo) >=
          (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return p.epi == RAW ? dispatch<int>(variant, a, w, out, p, st)
                      : dispatch<int8_t>(variant, a, w, out, p, st);
}
