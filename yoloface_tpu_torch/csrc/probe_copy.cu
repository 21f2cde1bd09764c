// Identity copies and the stride-2 phase select of the tools/ probes.
//
// Replaces the copy kernels of the JAX probes: the int8 tile copy of
// tools/microbench.py::main (:758, the floor of its dw-shaped variants),
// the identity kernels that fed an XLA consumer in
// tools/debug448_fix.py::main (pallas_ident :66, one frame tile a step),
// tools/debug448_rep.py::main (blocked_ident :52, blocks shaped like a
// strip section's output) and tools/debug448_min.py::main (pallas_ident :51,
// one frame a step), and probe A of tools/probe448_micro.py::main (:48, the
// even-W phase select x[::2]).  Plain versions: kernels/probes.py
// (Tensor.clone and x[:, ::2].contiguous()).
//
// What bounds it on the card: device-memory bandwidth, every byte read once
// and written once.  What the design does about it: 16-byte loads and
// stores wherever the rows and pointers allow, with byte moves otherwise,
// and kCopyInFlight independent 16-byte loads a thread issued before its
// first store (the last round predicated), so that a schedule of one block
// a row still has the bytes in flight that 3.35 TB/s needs: by Little's
// law about 20 KB an SM, where one load at a time gave 4 KB (256 threads)
// and the per-frame copy of 128 frames on 132 SMs ran at 1.73x
// Tensor.clone.  Two schedules: FLAT, a grid-stride walk of the whole
// tensor (the floor the probes state as a share of 3.35 TB/s), and ROWS,
// one block a row on a 2-D grid (row = blockIdx.y * gridDim.x +
// blockIdx.x), which is the per-frame copy (a row a frame), the
// strip-blocked copy (gridDim.x strips of each frame) and, with a source
// stride of two rows, the phase select.  It launches on the caller's
// stream and never synchronises, so a torch op queued after it on that
// stream reads what it wrote: the question the debug448 counterparts ask
// on the card.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode { FLAT = 0, ROWS = 1 };
// threads a block, and the 16-byte loads a thread has in flight: of 256
// and 512 threads with 1, 4 or 8 loads, 512 x 4 ran the per-frame copies of
// t73 and t99 at 128 fastest on an H100 (1.05x and 0.87x Tensor.clone;
// 256 x 1, the old form, 1.32x and 0.94x; 512 x 8 1.05x and 1.00x:
// tools/torch_variant_sweep.py copy)
constexpr int kCopyThreads = 512;
constexpr int kCopyInFlight = 4;

template <int kMode, bool kVec>
__global__ void __launch_bounds__(kCopyThreads)
    probe_copy_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                      long long bytes, int row_bytes, long long src_stride) {
  const int8_t* s = src;
  int8_t* d = dst;
  long long n = bytes;
  long long i0 =
      static_cast<long long>(blockIdx.x) * kCopyThreads + threadIdx.x;
  long long step = static_cast<long long>(gridDim.x) * kCopyThreads;
  if constexpr (kMode == ROWS) {
    const long long r =
        static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    s = src + r * src_stride;
    d = dst + r * row_bytes;
    n = row_bytes;
    i0 = threadIdx.x;
    step = kCopyThreads;
  }
  long long done = 0;
  if constexpr (kVec) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* d4 = reinterpret_cast<int4*>(d);
    const long long n16 = n >> 4;
    for (long long g = i0; g < n16; g += kCopyInFlight * step) {
      int4 v[kCopyInFlight];
#pragma unroll
      for (int u = 0; u < kCopyInFlight; ++u)
        if (g + u * step < n16) v[u] = __ldg(s4 + g + u * step);
#pragma unroll
      for (int u = 0; u < kCopyInFlight; ++u)
        if (g + u * step < n16) d4[g + u * step] = v[u];
    }
    done = n16 << 4;
  }
  for (long long i = done + i0; i < n; i += step) d[i] = s[i];
}

template <int kMode, bool kVec>
void launch(dim3 grid, const int8_t* src, int8_t* dst, long long bytes,
            int row_bytes, long long src_stride, cudaStream_t stream) {
  probe_copy_kernel<kMode, kVec><<<grid, kCopyThreads, 0, stream>>>(
      src, dst, bytes, row_bytes, src_stride);
}

}  // namespace

// params: mode, rows_x, rows_y, row_bytes, src_stride (bytes; ROWS), vec
// (16-byte moves: the caller checked the alignment).  FLAT copies rows_x *
// rows_y * row_bytes contiguous bytes.
extern "C" int yf_probe_copy(const void* src, void* dst, const int* params,
                             void* stream) {
  const int mode = params[0], rows_x = params[1], rows_y = params[2];
  const int row_bytes = params[3], src_stride = params[4], vec = params[5];
  if (rows_x <= 0 || rows_y <= 0 || row_bytes <= 0 || rows_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const int8_t*>(src);
  auto* d = static_cast<int8_t*>(dst);
  auto st = static_cast<cudaStream_t>(stream);
  if (mode == FLAT) {
    const long long bytes =
        static_cast<long long>(rows_x) * rows_y * row_bytes;
    const long long units = vec ? (bytes >> 4) : bytes;
    long long blocks = (units + kCopyThreads - 1) / kCopyThreads;
    // at most 132 SMs x 4096 threads (16 blocks of 256 an SM)
    if (blocks > 132 * 4096 / kCopyThreads)
      blocks = 132 * 4096 / kCopyThreads;
    if (blocks < 1) blocks = 1;
    const dim3 grid(static_cast<unsigned>(blocks));
    if (vec) launch<FLAT, true>(grid, s, d, bytes, 0, 0, st);
    else launch<FLAT, false>(grid, s, d, bytes, 0, 0, st);
  } else if (mode == ROWS) {
    const dim3 grid(rows_x, rows_y);
    if (vec) launch<ROWS, true>(grid, s, d, 0, row_bytes, src_stride, st);
    else launch<ROWS, false>(grid, s, d, 0, row_bytes, src_stride, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
