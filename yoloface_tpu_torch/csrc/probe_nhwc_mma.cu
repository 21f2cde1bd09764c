// The NHWC 1x1 on the int8 tensor cores, row slabs streamed once through
// shared memory: the Hopper form of the conv1x1 probe (B9.1), of the
// in-kernel probe's R-times NHWC 1x1 (B9.3) and of the packdot probe's
// one-position and packed 1x1s (B9.5).
//
// Replaces, beside probe_conv.cu's MMA8 (kept as the probes' "(PR 7)"
// variants), the 1x1 of tools/microbench.py::conv1x1_probe (:23,
// pallas_call :48), the NHWC 1x1 of tools/microbench.py::inkernel_probe
// (:264, pallas_call :296), the 1x1s of
// tools/microbench.py::packdot_probe (:496, pallas_call :549) and the
// wrapping 8x8 dots of tools/probe448_micro.py::main (:20, pallas_calls
// :85 and :107) and ::main2 (:120, pallas_calls :172 and :196):
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
// kernels' 1x1 bodies run on it and this probe prices them.  B9.7 and
// B9.8 (WRAP, R = 1, K = Nout = 8, M = 917,504) move 14.68 MB, 0.0044 ms,
// near the cost of one launch, and those bytes fit the 50 MB L2, so the
// probe times them with L2 cold and warm and beside a one-row launch.  The
// tile kernel it replaces staged 64-row tiles with 4-byte loads, K padded to
// 64, then computed, then stored through an int32 tile one element a
// thread, in turn, and bumped its staged weights in shared memory between
// repetitions.  Here:
//  * blocks of 128 threads walk slabs of 256 rows; a warp owns 64 rows,
//    four 16-row m-tiles, for four times the independent mma chains of one
//    (on the card this beat 256 threads of two m-tiles at B9.3: `python3
//    -m yoloface_tpu_torch.probes.microbench rows_sweep`); the walk is
//    persistent (as many blocks as fit the card, strided over the slabs)
//    or in runs (block b takes slabs b * n .. b * n + n - 1: B9.8's block
//    a frame and grid of chunks), the ring's prefetch the same in both
//    (walk_grid in nhwc_mma.cuh); each walk is an instantiation of its
//    own, the runs in probe_nhwc_mma_runs.cu, so the persistent kernel's
//    code and registers stay as they were without the runs (a walk chosen
//    at run time moved B9.1's 128 registers to 109 and B9.3's 157 to 153
//    on the card);
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
// The kernel's code is nhwc_mma_kernel.cuh.  K not a multiple of 4 or
// Nout past 64 (B9.5's shapes) run the second kernel of the same design,
// nhwc_mma_any_kernel.cuh (its account in probe_nhwc_mma_any.cu); the
// sources share nhwc_mma.cuh.
#include "nhwc_mma_kernel.cuh"

namespace yf_nhwc {

Kernel fast_instantiation(int nt, int kc) { return fast_table<false>(nt, kc); }

namespace {

// nt n-tiles of 8 output channels (a group of them for any), kc chunks of
// 16 of K; any: K not a multiple of 4 or Nout past 64 (the kernel of
// probe_nhwc_mma_any.cu); runs: the walk in runs of slabs
Kernel instantiation(int nt, int kc, int any, int runs) {
  if (any) return runs ? any_runs_instantiation(nt, kc)
                       : any_instantiation(nt, kc);
  return runs ? fast_runs_instantiation(nt, kc) : fast_instantiation(nt, kc);
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
// mma_rows_plan), slabs_per_block (0: persistent blocks strided over the
// slabs; n > 0: block b takes slabs b * n .. b * n + n - 1, a grid of
// ceil(slabs / n)).  x int8 [m, k], w int8 [nout, k], out int32 [m, nout]
// (RAW), int8 [m, k] (SHIFT) or int8 [m, nout] (WRAP), each 16-byte
// aligned.  The wrapper (kernels/probes.py) checked the shapes; this
// checks them again.
extern "C" int yf_probe_nhwc_mma(const void* x, const void* w, void* out,
                                 const int* params, void* stream) {
  Params p;
  p.m = params[0]; p.k = params[1]; p.nout = params[2]; p.epi = params[3];
  p.reps = params[4]; p.stages = params[5];
  const int slabs_per_block = params[6];
  if (p.m < 1 || p.stages < 2 || p.stages > kMaxStages || p.k < 1 ||
      p.k > 64 || p.nout < 1 || p.nout > 144 || p.reps < 1 ||
      slabs_per_block < 0 ||
      (p.epi != RAW && p.epi != SHIFT && p.epi != WRAP) ||
      (p.epi == SHIFT && p.nout > p.k) ||
      static_cast<long long>(p.m) * (p.k > p.nout ? p.k : p.nout) >=
          (1LL << 31) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(p.k, p.nout);
  const int kc = (p.k + 15) / 16;
  Kernel k = instantiation(s.tiles, kc, s.any, slabs_per_block > 0);
  p.slabs = (p.m + kRows - 1) / kRows;
  p.spb = slabs_per_block;
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
  const int grid = walk_grid(p, sms * per_sm);
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), out, p);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers a thread, local bytes a thread, static shared bytes
// and blocks an SM at `smem_bytes` of dynamic shared memory, of the
// instantiation for nt n-tiles of 8 output channels (a group's, for any),
// kc chunks of 16 of K, and form bit 0: any K and Nout (any) or K a
// multiple of 4 and Nout up to 64; bit 1: the walk in runs, else the
// persistent one.
extern "C" int yf_probe_nhwc_mma_attrs(int nt, int kc, int form,
                                       int smem_bytes, int* out) {
  Kernel k = instantiation(nt, kc, form & 1, form >> 1 & 1);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return attrs_of(k, smem_bytes, out);
}
