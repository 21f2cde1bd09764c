// The per-op CONCATENATION kernel: dense int8 inputs [N,H,W,Ci] to a dense
// [N,H,W,sum Ci], input i at channel offset sum C<i, as one flat launch
// over the batch's N*H*W pixels.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::concat_channels (two
// inputs along dim 0 of [C,H,W,N], which JAX folds pairwise) for the
// per-op programs of kernels/perop.py whose kernel is concat_channels, in
// the N-ary form those programs hold (up to kMaxInputs inputs).  The
// wrapper and the plain version (torch.cat on the channel axis) are in
// kernels/move.py.
//
// What bounds it on the card: bytes.  Each input byte is read once and
// each output byte written once; there is no arithmetic.  A channel slice
// of a pixel is a few bytes at an odd offset (the corpus net's 18 of 36),
// so a kernel that copies slices moves bytes, not 16-byte chunks.  What the
// design does about it (a transpose through shared memory):
//  * a grid of the card's SMs times the blocks an SM holds walks tiles of
//    P pixels with a grid stride; P is a multiple of 16 where a tile can
//    hold 16, so each input's P*Ci bytes and the output's P*sum Ci bytes
//    are whole 16-byte chunks and every tile starts 16-byte aligned;
//  * a block loads each input's contiguous bytes of its tile into shared
//    memory with 16-byte loads, all of a thread's (up to four, across the
//    inputs) in flight at once (yf::stage);
//  * it then writes the output's bytes of the tile in 16-byte stores, each
//    gathered from shared memory: (pixel, channel, input) is worked out
//    once a chunk (one division and a scan of the offsets) and stepped
//    forward element by element, in elements of the largest power of two
//    (up to 16 bytes) that divides every Ci and the output's first byte:
//    two bytes for 18 + 18, four for 24 + 24, one read a chunk where every
//    Ci is a multiple of 16;
//  * a base that is not 16-byte aligned, the partial chunks at its ends
//    and a ragged last tile take the element path of the same kernel.
// One launch may also write a channel slice of a wider output: the output
// pixel p's slice starts at y + p * out_stride + out_off.  kernels/perop.py
// cuts a concat of more than kMaxInputs inputs into groups that way, one
// launch a group; such a slice is written element by element (elements of
// the largest power of two that also divides out_off and out_stride).
#include <cuda_runtime.h>

#include <cstdint>

#include "move.cuh"

namespace {

using yf::kMoveThreads;
using yf::kMoveTileBytes;

constexpr int kMaxInputs = 16;     // kernels/move.py MAX_INPUTS

struct Inputs {
  const int8_t* x[kMaxInputs];
  int c[kMaxInputs];               // bytes a pixel of each input
  int off[kMaxInputs + 1];         // its offset in an output pixel; the sum
  int n;                           // inputs
  int out_off, out_stride;         // the slice's first byte, a pixel's bytes
  int tile_px;                     // P pixels a tile
  long long pixels;                // N * H * W
  long long tiles;
};

template <class T>
__global__ void __launch_bounds__(kMoveThreads)
    concat_kernel(const __grid_constant__ Inputs in,
                  int8_t* __restrict__ y) {
  __shared__ __align__(16) int8_t tile[kMoveTileBytes];
  // the channel counts and offsets in elements of T, which the gather
  // indexes by each thread's own input
  __shared__ int ce[kMaxInputs], oe[kMaxInputs + 1];
  // yf::stage's sources: each input's bytes of the tile, and where they go
  __shared__ const int8_t* tile_src[kMaxInputs];
  __shared__ int tile_len[kMaxInputs], tile_at[kMaxInputs];
  constexpr int kE = static_cast<int>(sizeof(T));
  constexpr int kV = 16 / kE;                    // elements a chunk
  for (int i = threadIdx.x; i <= in.n; i += kMoveThreads) {
    oe[i] = in.off[i] / kE;
    if (i < in.n) ce[i] = in.c[i] / kE;
  }
  const int n = in.n, ct = in.off[in.n] / kE, tp = in.tile_px;
  const T* src = reinterpret_cast<const T*>(tile);
  for (long long t = blockIdx.x; t < in.tiles; t += gridDim.x) {
    const long long p0 = t * tp;
    const int np = static_cast<int>(min(static_cast<long long>(tp),
                                        in.pixels - p0));
    for (int i = threadIdx.x; i < n; i += kMoveThreads) {
      tile_src[i] = in.x[i] + p0 * in.c[i];      // input i at tp * off[i]
      tile_len[i] = np * in.c[i];
      tile_at[i] = tp * in.off[i];
    }
    __syncthreads();                             // the last tile is read
    yf::stage(tile_src, tile_len, tile_at, n, tile);
    __syncthreads();
    const int total = np * ct;                   // the tile's output
    if (in.out_stride != in.off[n]) {            // a slice: element by element
      T* d = reinterpret_cast<T*>(y + p0 * in.out_stride + in.out_off);
      const int se = in.out_stride / kE;
      for (int e = threadIdx.x; e < total; e += kMoveThreads) {
        const int p = e / ct, ch = e - p * ct;
        int i = 0;
        while (ch >= oe[i + 1]) ++i;
        d[p * se + ch] = src[tp * oe[i] + p * ce[i] + (ch - oe[i])];
      }
      continue;
    }
    T* d = reinterpret_cast<T*>(y + p0 * in.off[n]);
    const int lead = static_cast<int>(yf::addr(d) & 15) / kE;
    const int nk = (lead + total + kV - 1) / kV;
    for (int k = threadIdx.x; k < nk; k += kMoveThreads) {
      const int lo = max(k * kV - lead, 0);
      const int hi = min(k * kV - lead + kV, total);
      // the cursor: channel element ch of pixel p, in input i
      int p = lo / ct, ch = lo - p * ct, i = 0;
      while (ch >= oe[i + 1]) ++i;
      const T* s = src + tp * oe[i] + p * ce[i] + (ch - oe[i]);
      auto next = [&]() {
        const T v = *s++;
        if (++ch == oe[i + 1]) {
          if (++i == n) {
            i = 0;
            ch = 0;
            ++p;
          }
          s = src + tp * oe[i] + p * ce[i];
        }
        return v;
      };
      if (hi - lo == kV) {
        uint4 v = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < kV; ++u) yf::put<T>(v, u, next());
        *reinterpret_cast<uint4*>(d + lo) = v;
      } else {
        for (int b = lo; b < hi; ++b) d[b] = next();
      }
    }
  }
}

// Launch concat_kernel<T> on a grid of the card's SMs x the blocks of it
// an SM holds, each taking tiles of pixels sized by yf::tile_units.
template <class T>
int launch(Inputs in, int8_t* y, cudaStream_t stream) {
  static int blocks = 0;
  if (blocks == 0) {
    cudaError_t err;
    blocks = yf::resident_blocks(concat_kernel<T>, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  in.tile_px = static_cast<int>(
      yf::tile_units(in.pixels, in.off[in.n], 16, blocks));
  in.tiles = (in.pixels + in.tile_px - 1) / in.tile_px;
  const long long grid = in.tiles < blocks ? in.tiles : blocks;
  concat_kernel<T><<<static_cast<int>(grid), kMoveThreads, 0, stream>>>(
      in, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (int8 [pixels, out_stride]) channels [out_off, out_off + sum c) = the
// n inputs xs[i] (int8 [pixels, c[i]], dense; host arrays of n pointers
// and n counts) side by side; out_stride = sum c and out_off = 0 is a
// dense output.  Returns cudaErrorInvalidValue for n outside 1..16, a
// pixel of more input bytes than the tile (16384) or a slice past
// out_stride.
extern "C" int yf_concat_channels(const void* const* xs, const int* cs,
                                  int n, void* y, long long pixels,
                                  int out_off, int out_stride, void* stream) {
  if (n < 1 || n > kMaxInputs || pixels < 1 || out_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Inputs in{};
  uintptr_t bits = reinterpret_cast<uintptr_t>(y) |
                   static_cast<uintptr_t>(out_off) |
                   static_cast<uintptr_t>(out_stride);
  for (int i = 0; i < n; ++i) {
    if (cs[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    in.x[i] = static_cast<const int8_t*>(xs[i]);
    in.c[i] = cs[i];
    in.off[i + 1] = in.off[i] + cs[i];
    bits |= static_cast<uintptr_t>(cs[i]);
  }
  in.n = n;
  in.pixels = pixels;
  in.out_off = out_off;
  in.out_stride = out_stride;
  if (in.off[n] > kMoveTileBytes || out_off + in.off[n] > out_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_t* ys = static_cast<int8_t*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (yf::elem_bytes(bits)) {
    case 16: return launch<uint4>(in, ys, st);
    case 8: return launch<uint2>(in, ys, st);
    case 4: return launch<uint32_t>(in, ys, st);
    case 2: return launch<uint16_t>(in, ys, st);
    default: return launch<uint8_t>(in, ys, st);
  }
}
