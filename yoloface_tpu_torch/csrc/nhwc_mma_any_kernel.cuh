// nhwc_mma_any_kernel: the row-slab NHWC 1x1 on the int8 tensor cores for
// any K up to 64 and Nout up to 144, in either walk (its account:
// probe_nhwc_mma_any.cu).  Instantiated by probe_nhwc_mma_any.cu (the
// persistent walk) and probe_nhwc_mma_any_runs.cu (runs).
#pragma once

#include "nhwc_mma.cuh"

namespace yf_nhwc {
namespace {

// word wd (bytes 4wd..4wd+3) of a K-byte row at any byte offset: two
// aligned shared loads and a funnel shift, the bytes past K zero
__device__ __forceinline__ unsigned row_word(const unsigned char* row, int wd,
                                             int k) {
  const int b = 4 * wd;
  if (b >= k) return 0u;
  const uintptr_t at = reinterpret_cast<uintptr_t>(row) + b;
  const unsigned* w = reinterpret_cast<const unsigned*>(at & ~uintptr_t(3));
  const unsigned v =
      __funnelshift_r(w[0], w[1], static_cast<unsigned>(at & 3) * 8);
  return k - b >= 4 ? v : v & ((1u << (8 * (k - b))) - 1u);
}

// the any kernel's accumulators of n-tiles col0 / 8 .. + kNT into the
// slab's output:
// SHIFT over the staged input rows in place (channels Nout.. keep the
// input), WRAP and RAW into the output slab buffer
// c0, c1: row g, columns 8nt + 2t, +1; c2, c3: row g + 8
template <int kNT>
__device__ __forceinline__ void epilogue(const int (&acc)[kMTiles][kNT][4],
                                         unsigned char* sx,
                                         unsigned char* obuf, int r0,
                                         int col0, const Params& p) {
  if (p.epi == SHIFT) {                          // in place, over the input
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = col0 + 8 * nt + 2 * (threadIdx.x & 3);
          store_pair8(sx + (r0 + 16 * mt + 8 * h) * p.k + co,
                      pair8(clip_shift(acc[mt][nt][2 * h]),
                            clip_shift(acc[mt][nt][2 * h + 1])),
                      co, p.nout, (p.k & 1) == 0);
        }
  } else if (p.epi == WRAP) {
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = col0 + 8 * nt + 2 * (threadIdx.x & 3);
          store_pair8(obuf + (r0 + 16 * mt + 8 * h) * p.nout + co,
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
          const int co = col0 + 8 * nt + 2 * (threadIdx.x & 3);
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
}

// the same for any K up to 64 (A words funnel-shifted, masked past K) and
// Nout up to 144 (groups of kNT n-tiles, B from the block's table in shared
// memory), where K is not a multiple of 4 or Nout passes 64
template <int kNT, int kKC, bool kRuns>
__global__ void __launch_bounds__(kThreads, 1)
    nhwc_mma_any_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w, void* __restrict__ out,
                        Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ob = p.epi == SHIFT ? p.k : p.epi == RAW ? 4 * p.nout : p.nout;
  unsigned char* const obuf = smem + p.stages * p.stage_bytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < p.stages; ++s) {
      const long long slab =
          kRuns ? (s < p.spb ? static_cast<long long>(blockIdx.x) * p.spb + s
                             : p.slabs)
                : blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (slab < p.slabs) fill(smem + s * p.stage_bytes, &full[s], x, slab, p);
    }
  }
  // the B table: word (tile * kKC + c) * 32 + lane is chunk c of n-tile
  // `tile` for that lane, bytes w[8 tile + g][16c + 4t + i], zero past Nout
  // and K
  unsigned* const table = reinterpret_cast<unsigned*>(smem + p.table_off);
  const int words = p.groups * kNT * kKC * 32;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const int l = e & 31, c = (e >> 5) % kKC, tile = (e >> 5) / kKC;
    const int co = 8 * tile + (l >> 2), k0 = 16 * c + 4 * (l & 3);
    unsigned v = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (co < p.nout && k0 + i < p.k)
        v |= static_cast<unsigned>(
                 static_cast<uint8_t>(__ldg(w + co * p.k + k0 + i)))
             << (8 * i);
    table[e] = v;
  }
  __syncthreads();
  const int r0 = warp * 16 * kMTiles + g;        // the lane's first row
  for (int it = 0;; ++it) {
    const long long slab =
        kRuns ? (it < p.spb ? static_cast<long long>(blockIdx.x) * p.spb + it
                            : p.slabs)
              : blockIdx.x + static_cast<long long>(it) * gridDim.x;
    if (slab >= p.slabs) break;
    const int st = it % p.stages;
    unsigned char* const sx = smem + st * p.stage_bytes;
    const long long row0 = slab * kRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                          static_cast<long long>(p.m) - row0));
    while (!mbar_try(smem_u32(&full[st]), (it / p.stages) & 1)) {
    }
    const int nbytes = rows * p.k, bulk = nbytes & ~15;
    if (bulk != nbytes) {          // the ragged last slab's last bytes
      if (threadIdx.x < nbytes - bulk)
        sx[bulk + threadIdx.x] =
            static_cast<unsigned char>(x[row0 * p.k + bulk + threadIdx.x]);
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
          a[mt][c][h] =
              row_word(sx + (r0 + 16 * mt + 8 * h) * p.k, 4 * c + t, p.k);
        }
    for (int grp = 0; grp < p.groups; ++grp) {
      unsigned b[kNT][kKC];          // this group's B, as W
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < kKC; ++c)
          b[nt][c] = table[((grp * kNT + nt) * kKC + c) * 32 + lane];
      int acc[kMTiles][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
      for (int r = 0; r < p.reps; ++r) {
        if (r > 0) bump(b, 0x01010101u);         // W + r, each byte wrapped
#pragma unroll
        for (int c = 0; c < kKC; c += 2)
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              if (c + 1 < kKC)
                mma_k32(acc[mt][nt], a[mt][c][0], a[mt][c][1],
                        a[mt][c + 1][0], a[mt][c + 1][1], b[nt][c],
                        b[nt][c + 1]);
              else
                mma_k16(acc[mt][nt], a[mt][c][0], a[mt][c][1], b[nt][c]);
            }
      }
      if (grp == 0) {
        if (p.epi != SHIFT) {    // the buffer is free once its store read it
          if (threadIdx.x == 0)
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          __syncthreads();
        } else {
          __syncwarp();          // the warp's A words are in (in place)
        }
      }
      epilogue<kNT>(acc, sx, obuf, r0, 8 * kNT * grp, p);
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
      const long long next =
          kRuns ? (it + p.stages - 1 < p.spb ? slab + p.stages - 1 : p.slabs)
                : slab + static_cast<long long>(p.stages - 1) * gridDim.x;
      if (it > 0 && next < p.slabs) {
        const int s = (it - 1) % p.stages;
        fill(smem + s * p.stage_bytes, &full[s], x, next, p);
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// nhwc_mma_any_kernel for kc chunks of 16 of K, nt n-tiles of 8 (nullptr past 4
// and 8) in the walk kRuns
template <int kNT, bool kRuns>
Kernel any_by_chunks(int kc) {
  switch (kc) {
    case 1: return nhwc_mma_any_kernel<kNT, 1, kRuns>;
    case 2: return nhwc_mma_any_kernel<kNT, 2, kRuns>;
    case 3: return nhwc_mma_any_kernel<kNT, 3, kRuns>;
    case 4: return nhwc_mma_any_kernel<kNT, 4, kRuns>;
    default: return nullptr;
  }
}

template <bool kRuns>
Kernel any_table(int nt, int kc) {
  switch (nt) {
    case 1: return any_by_chunks<1, kRuns>(kc);
    case 2: return any_by_chunks<2, kRuns>(kc);
    case 3: return any_by_chunks<3, kRuns>(kc);
    case 4: return any_by_chunks<4, kRuns>(kc);
    case 5: return any_by_chunks<5, kRuns>(kc);
    case 6: return any_by_chunks<6, kRuns>(kc);
    case 7: return any_by_chunks<7, kRuns>(kc);
    case 8: return any_by_chunks<8, kRuns>(kc);
    default: return nullptr;
  }
}

}  // namespace
}  // namespace yf_nhwc
