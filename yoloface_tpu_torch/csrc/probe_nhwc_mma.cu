// The NHWC 1x1 on the int8 tensor cores, row slabs streamed once through
// shared memory: the Hopper form of the conv1x1 probe (B9.1), of the
// in-kernel probe's R-times NHWC 1x1 (B9.3) and of the packdot probe's
// one-position and packed 1x1s (B9.5).
//
// Replaces, beside probe_conv.cu's MMA8 (kept as the probes' "(PR 7)"
// variants and as the kernel of probe448_micro), the 1x1 of
// tools/microbench.py::conv1x1_probe (:23, pallas_call :48), the NHWC 1x1
// of tools/microbench.py::inkernel_probe (:264, pallas_call :296) and the
// 1x1s of tools/microbench.py::packdot_probe (:496, pallas_call :549):
// x int8 [M, K] row-major (NHWC positions by channels), w int8 [Nout, K];
// acc[m, co] = sum_{r < R} sum_k int8(w[co, k] + r) * x[m, k] (the weights
// plus r wrap to int8, as the JAX probes' int8 `w + r` does); RAW: int32
// [M, Nout] sums; SHIFT: int8 [M, K], channel co < Nout clip(acc >> 7) and
// the channels Nout..K-1 copied from x; WRAP: int8 [M, Nout], int8(acc) as
// two's complement truncation.  Plain version: kernels/probes.py
// probe_conv_plain.
//
// What bounds it on the card: device-memory bytes.  B9.1 (SHIFT, R = 1, K
// 36, Nout 24, M = 6,422,528) moves 462.4 MB, 0.138 ms at 3.35 TB/s, where
// its 5.55 G MACs take 0.006 ms on the int8 tensor cores; B9.3 (RAW, R =
// 16, K = Nout = 36) moves 1,156 MB, 0.345 ms, 925 MB of it the int32
// output, where its 133.2 G MACs take 0.135 ms at 1,979 TOPS (issued: Nout
// padded to 40 and K to 48, 197 G).  mma.sync does not reach that rate
// (the card's dense int8 rate is wgmma's), so B9.3's 16 passes, not its
// bytes, set its time here; it stays on mma.sync because the stage
// kernels' 1x1 bodies run on it and this probe prices them.  The tile
// kernel it replaces staged 64-row tiles with 4-byte loads, K padded to
// 64, then computed, then stored through an int32 tile one element a
// thread, in turn, and bumped its staged weights in shared memory between
// repetitions.  Here:
//  * persistent blocks of 128 threads walk slabs of 256 rows; a warp owns
//    64 rows, four 16-row m-tiles, for four times the independent mma
//    chains of one (on the card this beat 256 threads of two m-tiles at
//    B9.3: `python3 -m yoloface_tpu_torch.probes.microbench rows_sweep`);
//  * each slab comes into a ring of 2-4 stages in shared memory (the
//    wrapper's plan: the most that keep three blocks an SM) by one
//    cp.async.bulk (the tensor memory accelerator) that completes on the
//    stage's mbarrier, so the next slabs load while this one computes and
//    each input byte is read once (a ragged last slab's last words, under
//    16 bytes, by plain loads);
//  * K runs in chunks of 16 (four words a row): a pair of chunks is one
//    mma.sync.m16n8k32 s8, an odd last chunk one m16n8k16 (K 36: 48 of
//    it, where the tile kernel padded to 64); lane (g, t) loads word 4c + t
//    of its rows g and g + 8 of chunk c with 4-byte shared loads (a row of
//    K/4 words, odd at K 36, so the rows spread over the banks), zero past
//    K, once a slab, and keeps them for all R repetitions;
//  * the weights' B fragments (w [Nout, K] row-major is the .col operand:
//    word 4c + t of row 8nt + g, zero past Nout and K) sit in registers for
//    the whole launch; between repetitions every B register takes
//    __vadd4(b, 0x01010101), so each byte wraps as int8 w + r, and after R
//    one __vadd4 of -(R - 1) brings them back.  The kernel runs R real
//    passes of the tensor cores, each on W + r: the repetitions are never
//    folded into one sum of weights, which would compute the same sums and
//    remove what the probe measures.  Padded K bytes become r, harmless
//    because A's padding is zero; padded Nout columns are never stored;
//  * the epilogue writes through shared memory: SHIFT writes clip(acc >> 7)
//    into channels 0..Nout-1 of the warp's own staged rows in place (after
//    a __syncwarp: the warp has its A words), where channels Nout..K-1
//    already hold the input, so the staged slab is the output slab; RAW
//    (int32) and WRAP (int8) write into one output slab buffer once the
//    last slab's store has read it (one buffer, not two, so that three
//    blocks fit an SM and hide each slab's load, epilogue and barriers
//    behind the others' passes); the slab leaves in one cp.async.bulk
//    store (a ragged last slab's last bytes, under 16, by plain stores),
//    and the stage is reused once its store has read it.  Storing the
//    int32 sums straight from the registers, a warp's 8-byte stores
//    4 * Nout bytes apart, ran slower on the card: they cut the rows into
//    partial 32-byte sectors.
// Rows past M in a ragged last slab are computed on whatever the stage
// holds and never stored.
//
//
// K not a multiple of 4 or Nout past 64 (B9.5's shapes) run the second
// kernel of the same design, probe_nhwc_mma_any.cu (its account there);
// the two sources share nhwc_mma.cuh.
#include "nhwc_mma.cuh"

namespace yf_nhwc {
namespace {

// one block an SM asked: left to choose, ptxas spilled 4-8 bytes in two
// instantiations (4 n-tiles by 1 k chunk, 5 by 2) to reach an occupancy step
template <int kNT, int kKC>
__global__ void __launch_bounds__(kThreads, 1)
    nhwc_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    void* __restrict__ out, Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = p.k >> 2;                       // words a row
  const int ob = p.epi == SHIFT ? p.k : p.epi == RAW ? 4 * p.nout : p.nout;
  unsigned char* const obuf = smem + p.stages * p.stage_bytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < p.stages; ++s) {
      const long long slab = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (slab < p.slabs) fill(smem + s * p.stage_bytes, &full[s], x, slab, p);
    }
  }
  __syncthreads();
  // W's B fragments: chunk c of n-tile nt, word 4c + t of row 8nt + g
  unsigned b[kNT][kKC];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      const int co = 8 * nt + g, wd = 4 * c + t;
      b[nt][c] = co < p.nout && wd < kw
                     ? __ldg(reinterpret_cast<const unsigned*>(w + co * p.k) +
                             wd)
                     : 0u;
    }
  const int r0 = warp * 16 * kMTiles + g;        // the lane's first row
  for (int it = 0;; ++it) {
    const long long slab = blockIdx.x + static_cast<long long>(it) * gridDim.x;
    if (slab >= p.slabs) break;
    const int st = it % p.stages;
    unsigned char* const sx = smem + st * p.stage_bytes;
    const long long row0 = slab * kRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                          static_cast<long long>(p.m) - row0));
    while (!mbar_try(smem_u32(&full[st]), (it / p.stages) & 1)) {
    }
    const int nbytes = rows * p.k, bulk = nbytes & ~15;
    if (bulk != nbytes) {          // the ragged last slab's last words
      if (threadIdx.x < (nbytes - bulk) >> 2)
        reinterpret_cast<unsigned*>(sx + bulk)[threadIdx.x] = __ldg(
            reinterpret_cast<const unsigned*>(x + row0 * p.k + bulk) +
            threadIdx.x);
      __syncthreads();
    }
    // A: m-tile mt, chunk c, rows g (h 0) and g + 8 (h 1): word 4c + t
    unsigned a[kMTiles][kKC][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int c = 0; c < kKC; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int wd = 4 * c + t;
          a[mt][c][h] =
              wd < kw ? *reinterpret_cast<const unsigned*>(
                            sx + (r0 + 16 * mt + 8 * h) * p.k + 4 * wd)
                      : 0u;
        }
    int acc[kMTiles][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    for (int r = 0; r < p.reps; ++r) {
      if (r > 0) bump(b, 0x01010101u);           // W + r, each byte wrapped
#pragma unroll
      for (int c = 0; c < kKC; c += 2)
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if (c + 1 < kKC)
              mma_k32(acc[mt][nt], a[mt][c][0], a[mt][c][1], a[mt][c + 1][0],
                      a[mt][c + 1][1], b[nt][c], b[nt][c + 1]);
            else
              mma_k16(acc[mt][nt], a[mt][c][0], a[mt][c][1], b[nt][c]);
          }
    }
    if (p.reps > 1)                              // back to W
      bump(b, (static_cast<unsigned>(1 - p.reps) & 0xFFu) * 0x01010101u);
    // c0, c1: row g, columns 8nt + 2t, +1; c2, c3: row g + 8
    if (p.epi != SHIFT) {        // the buffer is free once its store read it
      if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
    }
    if (p.epi == SHIFT) {                        // in place, over the input
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = 8 * nt + 2 * t;
            store_pair8(sx + (r0 + 16 * mt + 8 * h) * p.k + co,
                        pair8(clip_shift(acc[mt][nt][2 * h]),
                              clip_shift(acc[mt][nt][2 * h + 1])),
                        co, p.nout, true);
          }
    } else if (p.epi == WRAP) {
      unsigned char* const so = obuf;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = 8 * nt + 2 * t;
            store_pair8(so + (r0 + 16 * mt + 8 * h) * p.nout + co,
                        pair8(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]), co,
                        p.nout, (p.nout & 1) == 0);
          }
    } else {
      int* const so = reinterpret_cast<int*>(obuf);
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = 8 * nt + 2 * t;
            int* const dst = so + (r0 + 16 * mt + 8 * h) * p.nout + co;
            if (co + 1 < p.nout) {
              if ((p.nout & 1) == 0) {
                *reinterpret_cast<int2*>(dst) =
                    make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
              } else {
                dst[0] = acc[mt][nt][2 * h];
                dst[1] = acc[mt][nt][2 * h + 1];
              }
            } else if (co < p.nout) {
              dst[0] = acc[mt][nt][2 * h];
            }
          }
    }
    // the slab leaves once every thread's writes are visible to the bulk
    // copy (and, for SHIFT, the last slab's store has read its stage,
    // which the refill below takes)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0 && p.epi == SHIFT)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned char* src = p.epi == SHIFT ? sx : obuf;
      char* dst = static_cast<char*>(out) + row0 * ob;
      const int n = rows * ob, nb = n & ~15;
      if (nb)
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            "cp.async.bulk.commit_group;\n" ::"l"(dst),
            "r"(smem_u32(src)), "r"(nb)
            : "memory");
      for (int i = nb; i < n; ++i) dst[i] = static_cast<char>(src[i]);
      // the stage of the last slab, whose store has read it, takes the
      // slab stages - 1 ahead of this one
      const long long next = slab + static_cast<long long>(p.stages - 1) *
                                        gridDim.x;
      if (it > 0 && next < p.slabs) {
        const int s = (it - 1) % p.stages;
        fill(smem + s * p.stage_bytes, &full[s], x, next, p);
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int kNT>
Kernel by_chunks(int kc) {
  switch (kc) {
    case 1: return nhwc_mma_kernel<kNT, 1>;
    case 2: return nhwc_mma_kernel<kNT, 2>;
    case 3: return nhwc_mma_kernel<kNT, 3>;
    case 4: return nhwc_mma_kernel<kNT, 4>;
    default: return nullptr;
  }
}

// nt n-tiles of 8 output channels (a group of them for any), kc chunks of
// 16 of K; any: K not a multiple of 4 or Nout past 64
// (probe_nhwc_mma_any.cu)
Kernel instantiation(int nt, int kc, int any) {
  if (any) return any_instantiation(nt, kc);
  switch (nt) {
    case 1: return by_chunks<1>(kc);
    case 2: return by_chunks<2>(kc);
    case 3: return by_chunks<3>(kc);
    case 4: return by_chunks<4>(kc);
    case 5: return by_chunks<5>(kc);
    case 6: return by_chunks<6>(kc);
    case 7: return by_chunks<7>(kc);
    case 8: return by_chunks<8>(kc);
    default: return nullptr;
  }
}

// the instantiation's shape for K and Nout: whether it is kAny, the groups
// and the n-tiles of a group
struct Shape {
  int any, groups, tiles;
};

Shape shape_of(int k, int nout) {
  const int nt = (nout + 7) / 8;
  Shape s;
  s.any = (k & 3) != 0 || nout > 64;
  s.groups = s.any ? (nt + 7) / 8 : 1;
  s.tiles = (nt + s.groups - 1) / s.groups;
  return s;
}

int attrs_of(Kernel k, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace
}  // namespace yf_nhwc

using namespace yf_nhwc;

// params: m rows, k (1..64), nout (1..144; SHIFT: <= k), epi (0 RAW, 1
// SHIFT, 2 WRAP), reps (>= 1), stages (2..4: the plan, kernels/probes.py
// mma_rows_plan).  x int8 [m, k], w int8 [nout, k], out int32 [m, nout]
// (RAW), int8 [m, k] (SHIFT) or int8 [m, nout] (WRAP), each 16-byte
// aligned.  The wrapper (kernels/probes.py) checked the shapes; this
// checks them again.
extern "C" int yf_probe_nhwc_mma(const void* x, const void* w, void* out,
                                 const int* params, void* stream) {
  Params p;
  p.m = params[0]; p.k = params[1]; p.nout = params[2]; p.epi = params[3];
  p.reps = params[4]; p.stages = params[5];
  if (p.m < 1 || p.stages < 2 || p.stages > kMaxStages || p.k < 1 ||
      p.k > 64 || p.nout < 1 || p.nout > 144 || p.reps < 1 ||
      (p.epi != RAW && p.epi != SHIFT && p.epi != WRAP) ||
      (p.epi == SHIFT && p.nout > p.k) ||
      static_cast<long long>(p.m) * (p.k > p.nout ? p.k : p.nout) >=
          (1LL << 31) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(p.k, p.nout);
  const int kc = (p.k + 15) / 16;
  Kernel k = instantiation(s.tiles, kc, s.any);
  p.slabs = (p.m + kRows - 1) / kRows;
  p.stage_bytes = kRows * p.k;
  p.out_bytes = p.epi == SHIFT ? 0 : kRows * p.nout * (p.epi == RAW ? 4 : 1);
  p.groups = s.groups;
  p.table_off = p.stages * p.stage_bytes + p.out_bytes;
  const int smem = p.table_off + (s.any ? s.groups * s.tiles * kc * 128 : 0);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
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
  const int grid = min(p.slabs, sms * per_sm);
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), out, p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local bytes a thread, static shared bytes
// and blocks an SM at `smem_bytes` of dynamic shared memory, of the
// instantiation for nt n-tiles of 8 output channels (a group's, for any),
// kc chunks of 16 of K, and any K and Nout (any) or K a multiple of 4 and
// Nout up to 64.
extern "C" int yf_probe_nhwc_mma_attrs(int nt, int kc, int any,
                                       int smem_bytes, int* out) {
  Kernel k = instantiation(nt, kc, any);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return attrs_of(k, smem_bytes, out);
}
