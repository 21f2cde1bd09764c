// The per-op PAD kernel: a dense int8 [N,H,W,C] to [N,H+pt+pb,W+pl+pr,C],
// the input at (pt, pl) and `fill` everywhere else, as one flat launch over
// the batch's output rows.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::pad_int8 (a constant pad on
// the spatial dims of [C,W,H,N]) for the per-op programs of
// kernels/perop.py whose kernel is pad_int8.  The wrapper and the plain
// version (torch F.pad) are in kernels/move.py.
//
// What bounds it on the card: bytes.  Each input byte is read once and each
// output byte written once; there is no arithmetic.  The corpus net's PADs
// add one row and one column of C = 3, 18 or 24 channels, so an output row
// starts C bytes after its input row would: no 16-byte access lines up on
// both sides.  What the design does about it:
//  * the output is N*Ho rows of Wo*C bytes, and the input rows that feed a
//    run of output rows are one contiguous run of the input (pad rows have
//    none): a grid of the card's SMs times the blocks an SM holds walks
//    tiles of T output rows with a grid stride (T a multiple of 16 /
//    gcd(Wo*C, 16), so every tile starts 16-byte aligned, and at most 16 KB
//    of output), or, for a row of more than 16 KB, segments of one row;
//  * a block stages its tile's input run in shared memory with 16-byte
//    loads from the run's 16-byte-aligned start, all of a thread's (up to
//    four) in flight at once (yf::stage), the bytes past the last whole
//    chunk one by one; nothing outside the input is read;
//  * it then writes the tile's output in 16-byte stores: (row, column) is
//    worked out once a chunk.  A chunk wholly in the pad is the fill chunk,
//    built once; a chunk wholly inside one row's image is 16 bytes of
//    shared memory at a byte shift, five 32-bit reads and four funnel
//    shifts; a chunk across a border (the end of a row, its pad, the start
//    of the next) is, for C = 3 or 18, two such windows, one a row, and the
//    fill, merged by byte masks, so no thread of a warp walks the chunk
//    byte by byte (the corpus PADs at 16384 on an H100, C = 3: 0.2510 ms
//    gathered, 0.1561 merged; tools/torch_variant_sweep.py pad);
//  * a base that is not 16-byte aligned (stores; loads stage bytes), the
//    partial chunks at the ends, a ragged last tile, rows of fewer than 16
//    bytes and the border chunks of wider elements take the element path
//    of the same kernel: elements of the largest power of two (up to 16
//    bytes) that divides C and the output's first byte, each the fill or a
//    shared-memory read (C = 24: two of eight bytes).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "move.cuh"

namespace {

using yf::kMoveThreads;
using yf::kMoveTileBytes;

struct Shape {
  long long rows;      // output rows N * Ho
  int h, ho, pt;       // image rows, output rows a frame, top pad
  int row_in, row_out; // bytes a row
  int lb, rb;          // an output row's image bytes [lb, rb): pl*C, (pl+W)*C
  unsigned fill4;      // the fill byte four times
  int tile_rows;       // output rows a tile (1 where a row is cut)
  int seg;             // output bytes a tile holds of a row (row_out: whole)
  long long tiles;
};

// A block's shared memory: kSlack bytes, then the staged run (its 16-byte
// aligned start up to 15 bytes before the first byte wanted, then at most a
// tile), then room for a 16-byte window read from any staged byte on.  A
// window that a chunk takes bytes from starts at most 15 bytes before a
// staged byte, so within the slack.
constexpr int kSlack = 16;
constexpr int kPadSmem = kSlack + kMoveTileBytes + 16 + 32;

// the 16 bytes of shared memory from byte `at` on, at any alignment: five
// aligned 32-bit reads (four where `at` is aligned) and four funnel shifts
__device__ __forceinline__ uint4 load16(const int8_t* tile, int at) {
  const unsigned* w = reinterpret_cast<const unsigned*>(tile) + (at >> 2);
  const int sh = (at & 3) * 8;
  const unsigned a = w[0], b = w[1], c = w[2], d = w[3], e = sh ? w[4] : 0u;
  return make_uint4(__funnelshift_r(a, b, sh), __funnelshift_r(b, c, sh),
                    __funnelshift_r(c, d, sh), __funnelshift_r(d, e, sh));
}

// a window whose bytes may all be masked off: its start clamped into the
// buffer, so the read stays in it whatever the start
__device__ __forceinline__ uint4 window(const int8_t* tile, int at) {
  return load16(tile, min(max(at, 0), kPadSmem - 20));
}

// the byte mask of a 32-bit word whose bytes are bits 4i..4i+3 of `m`
__device__ __forceinline__ unsigned byte_mask(unsigned m, int i) {
  return (((m >> (4 * i)) & 15u) * 0x00204081u & 0x01010101u) * 255u;
}

// bits [lo, hi) of a 16-bit chunk mask (none where hi <= lo)
__device__ __forceinline__ unsigned span(int lo, int hi) {
  return hi > lo ? (1u << hi) - (1u << lo) : 0u;
}

template <class T>
__global__ void __launch_bounds__(kMoveThreads)
    pad_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y,
               Shape s) {
  __shared__ __align__(16) int8_t tile[kPadSmem];
  __shared__ const int8_t* tile_src[1];          // yf::stage's source
  __shared__ int tile_len[1], tile_at[1];
  constexpr int kE = static_cast<int>(sizeof(T));
  constexpr int kV = 16 / kE;                    // elements a chunk
  // rows and their image span in elements
  const int row_e = s.row_out / kE, in_e = s.row_in / kE;
  const int l0 = s.lb / kE, l1 = s.rb / kE, seg_e = s.seg / kE;
  const int segs = (row_e + seg_e - 1) / seg_e;  // segments a row
  const bool x16 = (yf::addr(x) & 15) == 0;
  const uint4 fill16 = make_uint4(s.fill4, s.fill4, s.fill4, s.fill4);
  T fe;                                          // the fill element
  memcpy(&fe, &fill16, sizeof(T));
  const T* src = reinterpret_cast<const T*>(tile + kSlack);
  auto image_rows = [&](int oy) { return min(max(oy - s.pt, 0), s.h); };
  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    long long r0;
    int c0 = 0, cw = row_e, nrows = 1;
    if (segs == 1) {
      r0 = t * s.tile_rows;
      nrows = static_cast<int>(min(static_cast<long long>(s.tile_rows),
                                   s.rows - r0));
    } else {
      r0 = t / segs;
      c0 = static_cast<int>(t - r0 * segs) * seg_e;
      cw = min(seg_e, row_e - c0);
    }
    // the input rows before output rows r0 and r0 + nrows: the tile's
    // image rows are [i0, i1), its image columns [x0, x1) (elements)
    const long long n0 = r0 / s.ho, r1 = r0 + nrows, n1 = r1 / s.ho;
    const int oy0 = static_cast<int>(r0 - n0 * s.ho);
    const long long i0 = n0 * s.h + image_rows(oy0);
    const long long i1 =
        n1 * s.h + image_rows(static_cast<int>(r1 - n1 * s.ho));
    const int x0 = min(max(c0 - l0, 0), in_e);
    const int x1 = min(max(c0 + cw - l0, 0), in_e);
    const long long start = (i0 * in_e + x0) * kE;   // bytes into x
    const int len = i1 == i0 ? 0
                    : (static_cast<int>(i1 - i0 - 1) * in_e + x1 - x0) * kE;
    const int lead = x16 ? static_cast<int>(start & 15) : 0;
    if (threadIdx.x == 0) {
      tile_src[0] = x + start - lead;
      tile_len[0] = len == 0 ? 0 : len + lead;
      tile_at[0] = kSlack;
    }
    __syncthreads();                             // the last tile is read
    yf::stage(tile_src, tile_len, tile_at, 1, tile);
    __syncthreads();
    int8_t* out0 = y + r0 * s.row_out + static_cast<long long>(c0) * kE;
    T* d = reinterpret_cast<T*>(out0);
    const int lead_o = static_cast<int>(yf::addr(out0) & 15) / kE;
    const int total = nrows * cw;                // the tile's output
    const int nk = (lead_o + total + kV - 1) / kV;
    // src[base + k * in_e + b]: output column b of the tile's k-th image row
    const int base = lead / kE - x0 - l0, top = image_rows(oy0);
    for (int q = threadIdx.x; q < nk; q += kMoveThreads) {
      const int lo = max(q * kV - lead_o, 0);
      const int hi = min(q * kV - lead_o + kV, total);
      // the cursor: column b of output row oy of a frame, the tile's
      // k-th image row where img
      const int j = lo / cw;
      int b = c0 + lo - j * cw, oy = oy0 + j;
      const int f = oy / s.ho;
      oy -= f * s.ho;
      int k = f * s.h + image_rows(oy) - top;
      bool img = oy >= s.pt && oy < s.pt + s.h;
      int srow = base + k * in_e;
      auto next = [&]() {
        const T v = img && b >= l0 && b < l1 ? src[srow + b] : fe;
        if (++b == row_e) {                      // the next output row
          b = 0;
          if (img) srow += in_e;
          if (++oy == s.ho) oy = 0;
          img = oy >= s.pt && oy < s.pt + s.h;
        }
        return v;
      };
      if (hi - lo == kV) {
        uint4 v;
        const bool one_row = b + kV <= row_e;
        if (one_row && (!img || b + kV <= l0 || b >= l1)) {
          v = fill16;
        } else if (one_row && b >= l0 && b + kV <= l1) {
          v = load16(tile, kSlack + (srow + b) * kE);
        } else if (kV >= 8 && row_e >= kV) {
          // rows j and j + 1 (o elements of row j in the chunk): each
          // one's image bytes from its window, the fill elsewhere (for
          // elements of 4 bytes or more the gather below takes at most
          // four reads: at C = 24 0.0686 ms gathered, 0.0804 merged)
          const int o = row_e - b, oy1 = oy + 1 == s.ho ? 0 : oy + 1;
          const bool img1 = o < kV && oy1 >= s.pt && oy1 < s.pt + s.h;
          const int srow1 = srow + (img ? in_e : 0);
          const unsigned ma =
              img ? span(max(l0 - b, 0) * kE, min(min(l1 - b, o), kV) * kE)
                  : 0u;
          const unsigned mb =
              img1 ? span((o + l0) * kE, min(o + l1, kV) * kE) : 0u;
          const uint4 wa = window(tile, kSlack + (srow + b) * kE);
          const uint4 wb = window(tile, kSlack + (srow1 - o) * kE);
          const unsigned a[4] = {wa.x, wa.y, wa.z, wa.w};
          const unsigned c[4] = {wb.x, wb.y, wb.z, wb.w};
          unsigned r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const unsigned ka = byte_mask(ma, i), kb = byte_mask(mb, i);
            r[i] = (a[i] & ka) | (c[i] & kb) | (s.fill4 & ~(ka | kb));
          }
          v = make_uint4(r[0], r[1], r[2], r[3]);
        } else {
          v = make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < kV; ++u) yf::put<T>(v, u, next());
        }
        *reinterpret_cast<uint4*>(d + lo) = v;
      } else {
        for (int e = lo; e < hi; ++e) d[e] = next();
      }
    }
  }
}

// Launch pad_kernel<T> on a grid of the card's SMs x the blocks of it an
// SM holds, each taking tiles of whole output rows (of a row's segments
// where a row passes the tile) sized by yf::tile_units.
template <class T>
int launch(const int8_t* x, int8_t* y, Shape s, cudaStream_t stream) {
  static int blocks = 0;
  if (blocks == 0) {
    cudaError_t err;
    blocks = yf::resident_blocks(pad_kernel<T>, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s.row_out <= kMoveTileBytes) {
    s.tile_rows = static_cast<int>(yf::tile_units(
        s.rows, s.row_out,
        16 / yf::elem_bytes(static_cast<uintptr_t>(s.row_out)), blocks));
    s.seg = s.row_out;
    s.tiles = (s.rows + s.tile_rows - 1) / s.tile_rows;
  } else {                         // segments of a row, one a tile
    s.tile_rows = 1;
    s.seg = kMoveTileBytes;
    s.tiles = s.rows * ((s.row_out + s.seg - 1) / s.seg);
  }
  const long long grid = s.tiles < blocks ? s.tiles : blocks;
  pad_kernel<T><<<static_cast<int>(grid), kMoveThreads, 0, stream>>>(x, y,
                                                                      s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (int8 [n, h+pt+pb, w+pl+pr, c], dense) = x (int8 [n, h, w, c], dense)
// at (pt, pl), `fill` elsewhere.  Returns cudaErrorInvalidValue for a
// negative pad or size, an empty output, a fill outside int8 or a row or
// frame count past 32 bits.
extern "C" int yf_pad_int8(const void* x, void* y, long long n, int h, int w,
                           int c, int pt, int pb, int pl, int pr, int fill,
                           void* stream) {
  const long long ho = static_cast<long long>(h) + pt + pb;
  const long long row_out = (static_cast<long long>(w) + pl + pr) * c;
  if (n < 1 || h < 0 || w < 0 || c < 1 || pt < 0 || pb < 0 || pl < 0 ||
      pr < 0 || fill < -128 || fill > 127 || ho < 1 || row_out < 1 ||
      ho > INT32_MAX || row_out > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{};
  s.rows = n * ho;
  s.h = h;
  s.ho = static_cast<int>(ho);
  s.pt = pt;
  s.row_in = w * c;
  s.row_out = static_cast<int>(row_out);
  s.lb = pl * c;
  s.rb = (pl + w) * c;
  s.fill4 = static_cast<unsigned>(static_cast<uint8_t>(fill)) * 0x01010101u;
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
