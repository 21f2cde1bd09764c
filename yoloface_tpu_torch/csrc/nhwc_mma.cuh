// The row-slab NHWC 1x1 on the int8 tensor cores (probe_nhwc_mma.cu,
// probe_nhwc_mma_any.cu and their walks in runs, probe_nhwc_mma_runs.cu and
// probe_nhwc_mma_any_runs.cu: four sources so that nvcc builds their
// instantiations at once): the block shape, the parameters, the walks and
// the device helpers both kernels use.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace yf_nhwc {

enum Epi { RAW = 0, SHIFT = 1, WRAP = 2 };   // probe_conv's codes

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMTiles = 4;              // 16-row m-tiles a warp
constexpr int kRows = 16 * kMTiles * kWarps;   // rows a slab
constexpr int kMaxStages = 4;           // slabs in the ring, at most

struct Params {
  int m, k, nout, epi, reps;
  int stages;                           // slabs in the ring (the plan's)
  int slabs;                            // ceil(m / kRows)
  int stage_bytes;                      // kRows * k
  int out_bytes;                        // the RAW / WRAP slab buffer
  int groups;                           // any: groups of kNT n-tiles
  int table_off;                        // any: the B table's offset
  int spb;                              // runs: slabs a block
};

// The walks (kRuns, a kernel's template parameter): the persistent one
// strides blocks over the slabs (block b: b, b + grid, ...); the walk in
// runs gives block b the p.spb slabs b * spb .. b * spb + spb - 1.  Each
// kernel writes its walk out where it reads a slab: through inline helpers
// here, ptxas allocated other registers to the persistent instantiations
// (B9.3's 157 became 153).

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// slab `slab`'s rows into `stage`: its bytes rounded down to 16 in one bulk
// copy that completes on `bar` (the rest, under 16 bytes of a ragged last
// slab, the consumers load)
__device__ __forceinline__ void fill(unsigned char* stage,
                                     unsigned long long* bar,
                                     const int8_t* __restrict__ x,
                                     long long slab, const Params& p) {
  const long long row0 = slab * kRows;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kRows), static_cast<long long>(p.m) - row0));
  const unsigned bytes = static_cast<unsigned>(rows * p.k) & ~15u;
  const unsigned b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(stage)),
        "l"(x + row0 * p.k), "r"(bytes), "r"(b)
        : "memory");
}

__device__ __forceinline__ void mma_k32(int (&d)[4], unsigned a0, unsigned a1,
                                        unsigned a2, unsigned a3, unsigned b0,
                                        unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int (&d)[4], unsigned a0, unsigned a1,
                                        unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

template <int kNT, int kKC>
__device__ __forceinline__ void bump(unsigned (&b)[kNT][kKC], unsigned by) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int c = 0; c < kKC; ++c) b[nt][c] = __vadd4(b[nt][c], by);
}

// the bytes of columns co, co + 1 (lo, hi of v) where they are below nout;
// a 2-byte store where both are and dst is 2-byte aligned
__device__ __forceinline__ void store_pair8(unsigned char* dst, unsigned v,
                                            int co, int nout, bool aligned) {
  if (co + 1 < nout) {
    if (aligned) {
      *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v);
    } else {
      dst[0] = static_cast<unsigned char>(v);
      dst[1] = static_cast<unsigned char>(v >> 8);
    }
  } else if (co < nout) {
    dst[0] = static_cast<unsigned char>(v);
  }
}

__device__ __forceinline__ unsigned pair8(int lo, int hi) {
  return (static_cast<unsigned>(lo) & 0xFFu) |
         (static_cast<unsigned>(hi) & 0xFFu) << 8;
}

__device__ __forceinline__ int clip_shift(int acc) {
  return min(max(acc >> 7, -128), 127);
}

using Kernel = void (*)(const int8_t*, const int8_t*, void*, Params);

// the kernels for nt n-tiles of 8 (a group's, for any) and kc chunks of 16
// of K (nullptr past 8 and 4), each walk's in a source of its own so that
// nvcc builds them at once: nhwc_mma_kernel (nhwc_mma_kernel.cuh) in
// probe_nhwc_mma.cu (persistent) and probe_nhwc_mma_runs.cu (runs),
// nhwc_mma_any_kernel (nhwc_mma_any_kernel.cuh) in probe_nhwc_mma_any.cu
// and probe_nhwc_mma_any_runs.cu
Kernel fast_instantiation(int nt, int kc);
Kernel fast_runs_instantiation(int nt, int kc);
Kernel any_instantiation(int nt, int kc);
Kernel any_runs_instantiation(int nt, int kc);

// the grid of a walk: in runs, ceil(slabs / spb) blocks; persistent, the
// blocks that fit the card (`resident`), or one a slab where fewer
inline int walk_grid(const Params& p, int resident) {
  return p.spb ? (p.slabs + p.spb - 1) / p.spb
               : (p.slabs < resident ? p.slabs : resident);
}

}  // namespace yf_nhwc
