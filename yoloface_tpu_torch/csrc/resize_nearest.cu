// The per-op RESIZE_NEAREST_NEIGHBOR kernel: a dense int8 [N,Hi,Wi,C] to
// [N,Hi*kh,Wi*kw,C] by the integer factors kh, kw, as one flat launch over
// the batch's input rows.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::resize_nearest (pixel
// replication on the spatial dims of [C,W,H,N]) for the per-op programs of
// kernels/perop.py whose kernel is resize_nearest.  The wrapper and the
// plain version (torch repeat_interleave on H, then on W) are in
// kernels/move.py.
//
// What bounds it on the card: bytes.  Each input byte is read once and
// kh*kw output bytes are written for it; there is no arithmetic.  What the
// design does about it:
//  * both tensors are dense, so input row r (r < N*Hi, Wi*C bytes) owns the
//    contiguous output rows r*kh .. r*kh + kh - 1: a grid of the card's SMs
//    times the blocks an SM holds walks tiles of whole input rows (or, for
//    a row wider than the tile, segments of one row) with a grid stride;
//  * a block stages its tile in shared memory with 16-byte loads, all of a
//    thread's (up to four) in flight at once (yf::stage), then writes the
//    tile's output rows in
//    16-byte stores, each gathered from shared memory: (pixel, channel) is
//    worked out once a chunk by division and stepped forward element by
//    element, in elements of the largest power of two (up to 16 bytes)
//    that divides C and the output's first byte, so C = 128 is one
//    shared-memory read a chunk and C = 8 two;
//  * where an output row is a multiple of 16 bytes, one gathered chunk is
//    stored kh times, once in each output row that repeats the input row;
//  * a base that is not 16-byte aligned, a partial chunk at either end of
//    an output row and a ragged last tile take the element path of the
//    same kernel.
#include <cuda_runtime.h>

#include <cstdint>

#include "move.cuh"

namespace {

using yf::kMoveThreads;
using yf::kMoveTileBytes;

struct Shape {
  long long rows;      // input rows N * Hi
  int wi, c, kh, kw;   // c in bytes
  int tile_rows;       // whole input rows a tile (1 where a row is split)
  int seg;             // input pixels a tile holds of a row (wi: whole rows)
  long long tiles;
};

template <class T>
__global__ void __launch_bounds__(kMoveThreads)
    resize_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y,
                  Shape s) {
  __shared__ __align__(16) int8_t tile[kMoveTileBytes];
  __shared__ const int8_t* tile_src[1];          // yf::stage's source
  __shared__ int tile_len[1], tile_at[1];
  constexpr int kE = static_cast<int>(sizeof(T));
  constexpr int kV = 16 / kE;                    // elements a chunk
  const long long row_in = static_cast<long long>(s.wi) * s.c;
  const long long row_out = row_in * s.kw;       // bytes
  const int segs = (s.wi + s.seg - 1) / s.seg;   // segments a row
  // where the output rows share an alignment, one gather serves all kh
  const bool same = row_out % 16 == 0;
  const int reps = same ? s.kh : 1, groups = s.kh / reps;
  const int ce = s.c / kE;                       // channels in elements
  const T* src = reinterpret_cast<const T*>(tile);
  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    long long r0;
    int ix0 = 0, width = s.wi, nrows = 1;
    if (segs == 1) {
      r0 = t * s.tile_rows;
      nrows = static_cast<int>(min(static_cast<long long>(s.tile_rows),
                                   s.rows - r0));
    } else {
      r0 = t / segs;
      ix0 = static_cast<int>(t - r0 * segs) * s.seg;
      width = min(s.seg, s.wi - ix0);
    }
    const int seg_in = width * ce;               // a staged row, elements
    const int seg_out = seg_in * s.kw;
    if (threadIdx.x == 0) {
      tile_src[0] = x + r0 * row_in + static_cast<long long>(ix0) * s.c;
      tile_len[0] = nrows * seg_in * kE;
      tile_at[0] = 0;
    }
    __syncthreads();                             // the last tile is read
    yf::stage(tile_src, tile_len, tile_at, 1, tile);
    __syncthreads();
    // output row q's segment starts at out0 + q * row_out
    int8_t* out0 = y + r0 * s.kh * row_out +
                   static_cast<long long>(ix0) * s.kw * s.c;
    const int lead0 = static_cast<int>(yf::addr(out0) & 15) / kE;
    const int nk = same ? (lead0 + seg_out + kV - 1) / kV
                        : seg_out / kV + 2;          // chunks a segment
    const int items = nrows * groups * nk;
    for (int e = threadIdx.x; e < items; e += kMoveThreads) {
      const int k = e % nk, jg = e / nk;
      const int j = jg / groups, q = j * s.kh + (jg - j * groups) * reps;
      T* d = reinterpret_cast<T*>(out0 + q * row_out);
      const int lead = static_cast<int>(yf::addr(d) & 15) / kE;
      const int lo = max(k * kV - lead, 0);
      const int hi = min(k * kV - lead + kV, seg_out);
      if (lo >= hi) continue;
      // the cursor: element c of pixel ix of staged row j, for the kx-th
      // copy of that pixel in the output row
      const int ox = lo / ce, ix = ox / s.kw;
      int c = lo - ox * ce, kx = ox - ix * s.kw;
      const T* p = src + j * seg_in + ix * ce + c;
      auto next = [&]() {
        const T v = *p++;
        if (++c == ce) {
          c = 0;
          if (++kx == s.kw) kx = 0; else p -= ce;
        }
        return v;
      };
      if (hi - lo == kV) {
        uint4 v = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < kV; ++u) yf::put<T>(v, u, next());
        for (int u = 0; u < reps; ++u)
          *reinterpret_cast<uint4*>(d + u * (row_out / kE) + lo) = v;
      } else {
        for (int b = lo; b < hi; ++b) {
          const T v = next();
          for (int u = 0; u < reps; ++u) d[u * (row_out / kE) + b] = v;
        }
      }
    }
  }
}

// Launch resize_kernel<T> on a grid of the card's SMs x the blocks of it
// an SM holds, each taking tiles of whole input rows (of a row's segments
// where a row passes the tile) sized by yf::tile_units.
template <class T>
int launch(const int8_t* x, int8_t* y, Shape s, cudaStream_t stream) {
  static int blocks = 0;
  if (blocks == 0) {
    cudaError_t err;
    blocks = yf::resident_blocks(resize_kernel<T>, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long row_in = static_cast<long long>(s.wi) * s.c;
  if (row_in <= kMoveTileBytes) {
    s.tile_rows = static_cast<int>(yf::tile_units(
        s.rows, row_in, 16 / yf::elem_bytes(static_cast<uintptr_t>(row_in)),
        blocks));
    s.tiles = (s.rows + s.tile_rows - 1) / s.tile_rows;
  } else {                         // segments of a row, one a tile
    const int align = 16 / yf::elem_bytes(static_cast<uintptr_t>(s.c));
    s.seg = kMoveTileBytes / s.c;
    if (s.seg >= align) s.seg = s.seg / align * align;
    s.tiles = s.rows * ((s.wi + s.seg - 1) / s.seg);
  }
  const long long grid = s.tiles < blocks ? s.tiles : blocks;
  resize_kernel<T><<<static_cast<int>(grid), kMoveThreads, 0, stream>>>(
      x, y, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (int8 [rows*kh, wi*kw, c], dense) = x (int8 [rows, wi, c], dense)
// with each pixel repeated kw times along a row and each row kh times.
// Returns cudaErrorInvalidValue for c above the tile (16384 bytes).
extern "C" int yf_resize_nearest(const void* x, void* y, long long rows,
                                 int wi, int c, int kh, int kw,
                                 void* stream) {
  if (c > kMoveTileBytes || rows < 1 || wi < 1 || c < 1 || kh < 1 || kw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{rows, wi, c, kh, kw, 1, wi, 0};
  const int8_t* xs = static_cast<const int8_t*>(x);
  int8_t* ys = static_cast<int8_t*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (yf::elem_bytes(static_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(y))) {
    case 16: return launch<uint4>(xs, ys, s, st);
    case 8: return launch<uint2>(xs, ys, s, st);
    case 4: return launch<uint32_t>(xs, ys, s, st);
    case 2: return launch<uint16_t>(xs, ys, s, st);
    default: return launch<uint8_t>(xs, ys, s, st);
  }
}
