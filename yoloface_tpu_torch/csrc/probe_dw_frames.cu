// Depthwise 3x3 taps on int8 NHWC frames, a block a group of whole frames:
// the Hopper form of the dw-shaped probe (B9.6).
//
// Replaces, beside probe_dw.cu's one-thread-an-output form (kept as the
// probe's "(PR 7)" variants), the int8-in, int8-out NHWC taps of
// tools/microbench.py::main (:633, pallas_call :682): x int8 [N, SP, SP,
// C], taps int32 [9, C] (tap dy*3+dx major); the so x so outputs at
// (o0, o0) are clip(acc >> 7), fast (f32) or exact (MBQM) requant of
// acc = sum_k x(y*s + dy, x*s + dx) * tap k (or x(y*s, x*s) * tap k
// without offsets), stride s 1 or 2; the rest of the output is the input
// (border copy) or zeros.  Plain version: kernels/probes.py probe_dw_plain.
//
// What bounds it on the card: device-memory bytes (each frame read once
// and written once; 9 MACs a byte on the CUDA cores stay under them).  The
// PR 7 form fetched each input byte up to nine times with byte loads,
// paid a div/mod decomposition an element and read the nine taps from
// memory for every output byte.  Here:
//  * a block of 256 threads takes groups of F whole frames (F from the
//    host's plan, kernels/probes.py dw_frames_plan) and walks them
//    grid-stride; each group comes into shared memory with 16-byte
//    cp.async, kStages groups deep, so the next groups load while this one
//    computes;
//  * a thread owns a channel word (4 channels) and a run of outputs along
//    a row, sliding a window of three input columns along it: one new
//    column an output at stride 1, two at stride 2;
//  * where every tap fits int8 (the block checks the taps once), the taps
//    sit in registers packed for __dp4a, a row of three taps of a channel
//    a word, and so does the window: one prmt brings a new column's byte
//    into a channel's word, one dp4a takes a row of taps (12 dp4a and 12
//    prmt an output word, where the int32 form takes 36 multiply-adds and
//    12 byte sign-extensions); other taps take the int32 form: 36 taps and
//    the window's sign-extended inputs in registers, the column slots
//    rotating at compile time (dw_step's template arguments), as without
//    offsets;
//  * the border is written beside the corner (rows above and below by
//    all threads, a corner row's sides by its first and last runs) into
//    an output buffer in shared memory, and the group leaves in one bulk
//    copy of the tensor memory accelerator (cp.async.bulk), so no thread
//    spends a load or a store on it;
//  * the epilogues are epilogue.cuh's (clip_i8, round_zp_clip, the 64-bit
//    requant_exact), as in the PR 7 form.
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

enum Epi { SHIFT = 0, FAST = 1, EXACT = 2 };
enum Border { COPY = 0, ZERO = 1 };

constexpr int kThreads = 256;
constexpr int kStages = 3;          // groups of frames in shared memory
constexpr int kBlocks = 2;          // blocks an SM the launch bound asks

struct Params {
  int n, sp, c, so, o0;             // x [n, sp, sp, c]; so x so at (o0, o0)
  int qm, shift, border;
  int frames, run, segs;            // the plan: frames a group, a row's runs
  int groups;                       // ceil(n / frames)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kN>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

// byte kB of w, sign-extended (prmt's sign-replicate selectors)
template <int kB>
__device__ __forceinline__ int sx(unsigned w) {
  int r;
  asm("prmt.b32 %0, %1, 0, %2;"
      : "=r"(r)
      : "r"(w), "n"(kB | ((8 | kB) << 4) | ((8 | kB) << 8) | ((8 | kB) << 12)));
  return r;
}

__device__ __forceinline__ void unpack(int (&v)[4], unsigned w) {
  v[0] = sx<0>(w);
  v[1] = sx<1>(w);
  v[2] = sx<2>(w);
  v[3] = sx<3>(w);
}

// frames [g * frames, +nf) of x into dst, 16-byte chunks (frame bytes are
// a multiple of 16 and x 16-byte aligned: the wrapper checks)
__device__ __forceinline__ void load_group(int8_t* dst,
                                           const int8_t* __restrict__ x,
                                           long long g, const Params& p,
                                           int fb) {
  if (g >= p.groups) return;
  const long long f0 = g * p.frames;
  const int nf = static_cast<int>(min(static_cast<long long>(p.frames),
                                      p.n - f0));
  const int chunks = (nf * fb) >> 4;
  const int8_t* src = x + f0 * fb;
  for (int i = threadIdx.x; i < chunks; i += kThreads)
    cp_async16(dst + 16 * i, src + 16 * i);
}

struct Taps {
  int w[9][4];                      // tap k of channels 4q..4q+3
  float sc[4];                      // the fast requant's scales
};

template <int kEpi>
__device__ __forceinline__ unsigned finish4(const int (&acc)[4],
                                            const Taps& t, const Params& p) {
  unsigned r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int v;
    if constexpr (kEpi == SHIFT) v = yf::clip_i8(acc[j] >> 7);
    else if constexpr (kEpi == FAST)
      v = yf::round_zp_clip(__fmul_rn(static_cast<float>(acc[j]), t.sc[j]),
                            0);
    else v = yf::requant_exact(acc[j], p.qm, p.shift, 0);
    r |= static_cast<unsigned>(static_cast<uint8_t>(v)) << (8 * j);
  }
  return r;
}

// the three input rows' words of one column: [dy][channel]
__device__ __forceinline__ void load_col(int (&col)[3][4], const int8_t* s,
                                         int rb) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
    unpack(col[dy], *reinterpret_cast<const unsigned*>(s + dy * rb));
}

// One output: the window's columns sit in slots kA, kB, kC; the column
// (stride 1) or two (stride 2) it needs beyond the last output's come in
// first.  s points at the window's first column (input row y*stride).
template <int kStride, int kEpi, int kA, int kB, int kC>
__device__ __forceinline__ void dw_step(int (&col)[3][3][4], const int8_t* s,
                                        int8_t* d, int rb, int c,
                                        const Taps& t, const Params& p) {
  if constexpr (kStride == 2) load_col(col[kB], s + c, rb);
  load_col(col[kC], s + 2 * c, rb);
  int acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] += col[kA][dy][j] * t.w[3 * dy][j] +
                col[kB][dy][j] * t.w[3 * dy + 1][j] +
                col[kC][dy][j] * t.w[3 * dy + 2][j];
  *reinterpret_cast<unsigned*>(d) = finish4<kEpi>(acc, t, p);
}

// Outputs [ox0, ox1) of one row and channel word.  src: the word's input
// at (row y*stride, column 0); dst: its output at (o0 + y, o0).
template <int kStride, bool kOffs, int kEpi>
__device__ __forceinline__ void dw_run(const int8_t* src, int8_t* dst,
                                       int ox0, int ox1, int rb, int c,
                                       const Taps& t, const Params& p) {
  if constexpr (!kOffs) {           // every tap reads (y*stride, x*stride)
    for (int ox = ox0; ox < ox1; ++ox) {
      int v[4];
      unpack(v, *reinterpret_cast<const unsigned*>(src + ox * kStride * c));
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += v[j] * t.w[k][j];
      *reinterpret_cast<unsigned*>(dst + ox * c) = finish4<kEpi>(acc, t, p);
    }
  } else {
    int col[3][3][4];               // [slot][dy][channel]
    const int step = kStride * c;   // bytes from one output's window to
    const int8_t* s = src + ox0 * step;     // the next's
    int8_t* d = dst + ox0 * c;
    load_col(col[0], s, rb);
    if constexpr (kStride == 1) load_col(col[1], s + c, rb);
    // the slots rotate with period three: stride 1 (0,1,2) (1,2,0)
    // (2,0,1); stride 2 (0,1,2) (2,0,1) (1,2,0)
    for (int ox = ox0; ox < ox1; ox += 3, s += 3 * step, d += 3 * c) {
      dw_step<kStride, kEpi, 0, 1, 2>(col, s, d, rb, c, t, p);
      if (ox + 1 >= ox1) break;
      if constexpr (kStride == 1)
        dw_step<1, kEpi, 1, 2, 0>(col, s + step, d + c, rb, c, t, p);
      else
        dw_step<2, kEpi, 2, 0, 1>(col, s + step, d + c, rb, c, t, p);
      if (ox + 2 >= ox1) break;
      if constexpr (kStride == 1)
        dw_step<1, kEpi, 2, 0, 1>(col, s + 2 * step, d + 2 * c, rb, c, t, p);
      else
        dw_step<2, kEpi, 1, 2, 0>(col, s + 2 * step, d + 2 * c, rb, c, t, p);
    }
  }
}

// The taps of one channel word packed for __dp4a: [dy][channel j] holds
// taps (dy, 0), (dy, 1), (dy, 2) of channel 4q + j as bytes 0..2 (byte 3
// zero), valid when every tap fits int8.
struct Packed {
  unsigned w[3][4];
};

// dw_run on __dp4a, with offsets: a word a (row dy, channel j) holds the
// window's three input bytes of that channel in bytes 0..2, so one dp4a
// takes a row of taps.  A new column (stride 1) shifts the bytes down one
// and brings byte j of the new word in as byte 2: one prmt a (dy, j); at
// stride 2 two columns come in (two prmts).  Byte 3 meets tap byte 3,
// zero.
template <int kStride, int kEpi>
__device__ __forceinline__ void dw4_run(const int8_t* src, int8_t* dst,
                                        int ox0, int ox1, int rb, int c,
                                        const Packed& pk, const Taps& t,
                                        const Params& p) {
  const int step = kStride * c;
  const int8_t* s = src + ox0 * step;
  int8_t* d = dst + ox0 * c;
  unsigned win[3][4];               // [dy][j]
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const unsigned a = *reinterpret_cast<const unsigned*>(s + dy * rb);
    if constexpr (kStride == 1) {   // columns 0, 1 as bytes 1, 2
      const unsigned b = *reinterpret_cast<const unsigned*>(s + c + dy * rb);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        win[dy][j] = __byte_perm(a, b, j | (j << 4) | ((4 + j) << 8));
    } else {                        // column 0 as byte 2
#pragma unroll
      for (int j = 0; j < 4; ++j) win[dy][j] = __byte_perm(a, 0, j * 0x1111);
    }
  }
  for (int ox = ox0; ox < ox1; ++ox, s += step, d += c) {
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const unsigned n =
          *reinterpret_cast<const unsigned*>(s + 2 * c + dy * rb);
      if constexpr (kStride == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          win[dy][j] = __byte_perm(win[dy][j], n,
                                   0x3001 | 0x20 | ((4 + j) << 8));
      } else {
        const unsigned m = *reinterpret_cast<const unsigned*>(s + c + dy * rb);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          win[dy][j] = __byte_perm(win[dy][j], __byte_perm(m, n, j | ((4 + j) << 4)),
                                   0x3542);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = __dp4a(static_cast<int>(win[dy][j]),
                        static_cast<int>(pk.w[dy][j]), acc[j]);
    }
    *reinterpret_cast<unsigned*>(d) = finish4<kEpi>(acc, t, p);
  }
}

// A group's border words (everything outside the so x so corner) into
// s_out: the input's (COPY) or zeros.  Whole rows above and below the
// corner here; a corner row's sides by the threads of its first and last
// runs (side_words).
__device__ __forceinline__ void border_rows(const int8_t* s_in, int8_t* s_out,
                                            int nf, const Params& p) {
  const int nq = p.c >> 2, rw = p.sp * nq, fw = p.sp * rw;   // words
  const int top = p.o0 * rw, bw = top + (p.sp - p.o0 - p.so) * rw;
  const unsigned* in = reinterpret_cast<const unsigned*>(s_in);
  unsigned* out = reinterpret_cast<unsigned*>(s_out);
  for (int i = threadIdx.x; i < nf * bw; i += kThreads) {
    const int f = i / bw, w = i - f * bw;
    const int o = f * fw + (w < top ? w : w + p.so * rw);
    out[o] = p.border == COPY ? in[o] : 0u;
  }
}

// word q of output pixels [x0, x1) of one row (offset `row` words)
__device__ __forceinline__ void side_words(const int8_t* s_in, int8_t* s_out,
                                           int row, int x0, int x1, int q,
                                           const Params& p) {
  const int nq = p.c >> 2;
  const unsigned* in = reinterpret_cast<const unsigned*>(s_in);
  unsigned* out = reinterpret_cast<unsigned*>(s_out);
  for (int px = x0; px < x1; ++px) {
    const int o = row + px * nq + q;
    out[o] = p.border == COPY ? in[o] : 0u;
  }
}

template <int kStride, bool kOffs, int kEpi>
__global__ void __launch_bounds__(kThreads, kBlocks)
    dw_frames_kernel(const int8_t* __restrict__ x,
                     const int* __restrict__ taps,
                     const float* __restrict__ scale,
                     int8_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int fb = p.sp * p.sp * p.c;            // bytes a frame
  const int gb = p.frames * fb;                // bytes a group (a stage)
  int8_t* s_out = smem + kStages * gb;
  const int nq = p.c >> 2, rb = p.sp * p.c;
  // the dp4a body when every tap fits int8 (one answer for the block)
  bool fits = kOffs;
  for (int i = threadIdx.x; i < 9 * p.c; i += kThreads) {
    const int v = __ldg(taps + i);
    fits = fits && v >= -128 && v <= 127;
  }
  const bool small = __syncthreads_and(fits);
  long long g = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_group(smem + s * gb, x, g + s * static_cast<long long>(gridDim.x), p,
               fb);
    cp_commit();
  }
  const unsigned s_out_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(s_out));
  Taps t;
  Packed pk;
  int cur_q = -1;
  for (int it = 0; g < p.groups; ++it, g += gridDim.x) {
    if (threadIdx.x == 0)          // the last group's store has read s_out
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    cp_wait<kStages - 2>();                    // this group is in
    __syncthreads();                           // (all threads' copies)
    load_group(smem + ((it + kStages - 1) % kStages) * gb, x,
               g + (kStages - 1) * static_cast<long long>(gridDim.x), p, fb);
    cp_commit();
    const int8_t* s_in = smem + (it % kStages) * gb;
    const int nf = static_cast<int>(
        min(static_cast<long long>(p.frames), p.n - g * p.frames));
    border_rows(s_in, s_out, nf, p);
    // items (frame, row, run, word), the word fastest
    const int items = nf * p.so * p.segs * nq;
    for (int item = threadIdx.x; item < items; item += kThreads) {
      const int q = item % nq;
      int r = item / nq;
      const int seg = r % p.segs;
      r /= p.segs;
      const int oy = r % p.so, f = r / p.so;
      if (q != cur_q) {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int4 v =
              __ldg(reinterpret_cast<const int4*>(taps + k * p.c + 4 * q));
          t.w[k][0] = v.x; t.w[k][1] = v.y; t.w[k][2] = v.z; t.w[k][3] = v.w;
        }
        if (small) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              pk.w[dy][j] = (static_cast<unsigned>(t.w[3 * dy][j]) & 0xFFu) |
                            (static_cast<unsigned>(t.w[3 * dy + 1][j]) & 0xFFu)
                                << 8 |
                            (static_cast<unsigned>(t.w[3 * dy + 2][j]) & 0xFFu)
                                << 16;
        }
        if constexpr (kEpi == FAST) {
          const float4 v =
              __ldg(reinterpret_cast<const float4*>(scale + 4 * q));
          t.sc[0] = v.x; t.sc[1] = v.y; t.sc[2] = v.z; t.sc[3] = v.w;
        }
        cur_q = q;
      }
      const int ox0 = seg * p.run, ox1 = min(ox0 + p.run, p.so);
      const int row = (f * p.sp + p.o0 + oy) * p.sp * nq;   // output row, words
      const int8_t* src = s_in + f * fb + oy * kStride * rb + 4 * q;
      int8_t* dst = s_out + 4 * (row + p.o0 * nq + q);
      if (kOffs && small)
        dw4_run<kStride, kEpi>(src, dst, ox0, ox1, rb, p.c, pk, t, p);
      else
        dw_run<kStride, kOffs, kEpi>(src, dst, ox0, ox1, rb, p.c, t, p);
      if (seg == 0) side_words(s_in, s_out, row, 0, p.o0, q, p);
      if (seg == p.segs - 1)
        side_words(s_in, s_out, row, p.o0 + p.so, p.sp, q, p);
    }
    // the group leaves in one bulk copy (the tensor memory accelerator)
    // once every thread's writes are visible to it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n" ::"l"(out + g * gb),
          "r"(s_out_addr), "r"(nf * fb)
          : "memory");
    }
  }
  cp_wait<0>();
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using Kernel = void (*)(const int8_t*, const int*, const float*, int8_t*,
                        Params);

template <int kStride, bool kOffs>
Kernel by_epi(int epi) {
  switch (epi) {
    case SHIFT: return dw_frames_kernel<kStride, kOffs, SHIFT>;
    case FAST: return dw_frames_kernel<kStride, kOffs, FAST>;
    case EXACT: return dw_frames_kernel<kStride, kOffs, EXACT>;
    default: return nullptr;
  }
}

Kernel instantiation(int stride, int offs, int epi) {
  if (stride == 1) return offs ? by_epi<1, true>(epi) : by_epi<1, false>(epi);
  if (stride == 2) return offs ? by_epi<2, true>(epi) : by_epi<2, false>(epi);
  return nullptr;
}

long long smem_of(const Params& p) {
  return static_cast<long long>(kStages + 1) * p.frames * p.sp * p.sp * p.c;
}

}  // namespace

// params: n, sp, c, so, o0, stride, offs, epi (0 shift, 1 fast, 2 exact),
// qm, shift, border (0 copy, 1 zero), frames, run, segs.  x and out int8
// [n, sp, sp, c], 16-byte aligned; taps int32 [9, c] and scale float32 [c]
// (fast only), 16-byte aligned.  The wrapper (kernels/probes.py) checked the shapes and
// planned frames / run / segs (dw_frames_plan); this checks them again.
extern "C" int yf_probe_dw_frames(const void* x, const void* taps,
                                  const void* scale, void* out,
                                  const int* params, void* stream) {
  Params p;
  p.n = params[0]; p.sp = params[1]; p.c = params[2]; p.so = params[3];
  p.o0 = params[4];
  const int stride = params[5], offs = params[6], epi = params[7];
  p.qm = params[8]; p.shift = params[9]; p.border = params[10];
  p.frames = params[11]; p.run = params[12]; p.segs = params[13];
  const long long fb = static_cast<long long>(p.sp) * p.sp * p.c;
  if (p.n < 1 || p.c < 4 || (p.c & 3) || (fb & 15) || p.so < 1 ||
      p.o0 < 0 || p.o0 + p.so > p.sp ||
      (p.so - 1) * stride + (offs ? 2 : 0) >= p.sp || p.frames < 1 ||
      p.run < 1 || p.segs < 1 || (p.segs - 1) * p.run >= p.so ||
      p.segs * p.run < p.so || (p.border != COPY && p.border != ZERO) ||
      fb * p.n >= (1LL << 31) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(taps) |
        reinterpret_cast<uintptr_t>(scale)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k = instantiation(stride, offs, epi);
  if (k == nullptr || smem_of(p) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_of(p));
  p.groups = (p.n + p.frames - 1) / p.frames;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(
      min(static_cast<long long>(p.groups),
          static_cast<long long>(sms) * per_sm));
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(taps),
      static_cast<const float*>(scale), static_cast<int8_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local bytes a thread, static shared bytes
// and blocks an SM at `smem_bytes` of dynamic shared memory, of the
// instantiation (stride, offs, epi).
extern "C" int yf_probe_dw_frames_attrs(int stride, int offs, int epi,
                                        int smem_bytes, int* out) {
  Kernel k = instantiation(stride, offs, epi);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}
