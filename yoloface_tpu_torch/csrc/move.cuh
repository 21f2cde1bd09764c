// What the per-op byte-move kernels (resize_nearest.cu, concat_channels.cu,
// pad_int8.cu) share: the tile of shared memory a block stages its input
// through and the staging itself, the grid and the tile size, and the
// packing of a 16-byte output chunk gathered from the tile in elements of
// T (1, 2, 4, 8 or 16 bytes: the largest power of two that divides the
// channel counts and the output's first byte, so a chunk takes
// 16 / sizeof(T) shared-memory reads, not 16).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "arena_ops.cuh"

namespace yf {

constexpr int kMoveThreads = 256;
// static shared memory a block stages one tile of its input through
constexpr int kMoveTileBytes = 16384;
// a tile is sized so that each block of the grid takes at least this many
// where the input allows: blocks that finish early find work
constexpr int kMoveTilesPerBlock = 4;

// a 16-byte chunk of elements of T (uint8_t, uint16_t, uint32_t, uint2 or
// uint4): put element `u` (a constant after unrolling) into `v`
template <class T>
__device__ __forceinline__ void put(uint4& v, int u, T e) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));   // a 32-bit word's
  const unsigned bits = static_cast<unsigned>(e)
                        << (8 * static_cast<int>(sizeof(T)) * (u % kPer));
  switch (u / kPer) {
    case 0: v.x |= bits; break;
    case 1: v.y |= bits; break;
    case 2: v.z |= bits; break;
    default: v.w |= bits;
  }
}
template <>
__device__ __forceinline__ void put<uint2>(uint4& v, int u, uint2 e) {
  if (u == 0) { v.x = e.x; v.y = e.y; } else { v.z = e.x; v.w = e.y; }
}
template <>
__device__ __forceinline__ void put<uint4>(uint4& v, int, uint4 e) { v = e; }

// Stage a tile into shared memory: the `m` sources src[k][0, len[k]) to
// dst + at[k] (src, len and at in shared memory, written before the
// block's last barrier).  Where every source and destination is 16-byte
// aligned, one pass over all the sources' 16-byte chunks, kInFlight loads
// a thread issued before the first store, the last round predicated: a
// tile of a few chunks a thread has them all in flight at once (the
// grouped loop of yf::map_flat needs kInFlight full rounds and would issue
// them one at a time, a source after another).  Then each source's bytes
// past its last whole chunk; bytes throughout where an address is not
// aligned.
__device__ __forceinline__ void stage(const int8_t* const* src,
                                      const int* len, const int* at, int m,
                                      int8_t* dst) {
  uintptr_t bits = 0;
  int n16 = 0;
  for (int k = 0; k < m; ++k) {
    bits |= addr(src[k]) | (addr(dst) + at[k]);
    n16 += len[k] / 16;
  }
  const bool chunks = (bits & 15) == 0;
  if (chunks) {
    for (int g0 = threadIdx.x; g0 < n16; g0 += kInFlight * kMoveThreads) {
      uint4 v[kInFlight];
      uint4* d[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        int g = g0 + u * kMoveThreads, k = 0;
        d[u] = nullptr;
        if (g >= n16) continue;
        while (g >= len[k] / 16) g -= len[k++] / 16;
        v[u] = reinterpret_cast<const uint4*>(src[k])[g];
        d[u] = reinterpret_cast<uint4*>(dst + at[k]) + g;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (d[u] != nullptr) *d[u] = v[u];
    }
  }
  for (int k = 0; k < m; ++k)
    for (int b = (chunks ? len[k] / 16 * 16 : 0) + threadIdx.x; b < len[k];
         b += kMoveThreads)
      dst[at[k] + b] = src[k][b];
}

// the blocks of the largest grid the card runs at once: its SMs x the
// blocks of `kernel` an SM holds (0 and the error on failure)
template <class K>
int resident_blocks(K kernel, cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kMoveThreads, 0);
  return *err == cudaSuccess ? sms * per_sm : 0;
}

// the size of a tile in units (rows, pixels) of `unit` bytes: at most the
// tile's bytes, a multiple of `align` units where one fits (so that every
// tile starts 16-byte aligned), and small enough that `total` units give
// each of `blocks` blocks kMoveTilesPerBlock tiles where they can
inline long long tile_units(long long total, long long unit, int align,
                            int blocks) {
  const long long most = kMoveTileBytes / unit;
  const long long per = static_cast<long long>(blocks) * kMoveTilesPerBlock;
  long long n = (total + per - 1) / per;
  n = (n + align - 1) / align * align;
  if (n > most) n = most >= align ? most / align * align : most;
  return n < 1 ? 1 : n;
}

// the largest power of two up to 16 that divides every bit pattern in
// `bits` (channel counts, an address)
inline int elem_bytes(uintptr_t bits) {
  bits |= 16;
  return static_cast<int>(bits & (~bits + 1));
}

}  // namespace yf
