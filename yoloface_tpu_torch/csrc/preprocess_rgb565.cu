// RGB565 camera frames -> int8 net input, bit-exact with the firmware.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::preprocess_rgb565.  Per
// output pixel: sum each 5/6/5 field over the 2x2 box, >> 2, widen
// (<< 3 / << 2 / << 3) and subtract 128.  [N,112,112] u16 -> [N,56,56,3]
// int8 NHWC, the layout the arena stages read.  Plain version:
// pipeline/preprocess.py::rgb565_to_int8_input.
//
// What bounds it on the card: device-memory bandwidth -- 8 bytes read and
// 3 written a pixel, a few integer ops between.  What the design does
// about it: one thread a pixel reads its two 2-pixel row pairs as aligned
// 4-byte words, so a warp's loads are contiguous 128-byte rows and its
// stores contiguous 96-byte runs.  The TPU kernel's int32 staging copy
// (for strided loads) has no counterpart here.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kIn = 112, kOut = 56, kPix = kOut * kOut;

__device__ __forceinline__ int field_sum(uint32_t ab, uint32_t cd, int shift,
                                         int mask) {
  return ((ab >> shift) & mask) + ((ab >> (16 + shift)) & mask) +
         ((cd >> shift) & mask) + ((cd >> (16 + shift)) & mask);
}

__global__ void preprocess_rgb565_kernel(const uint16_t* __restrict__ in,
                                         int8_t* __restrict__ out, int n) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * kPix) return;
  const long long f = idx / kPix;
  const int p = static_cast<int>(idx % kPix);
  const int y = p / kOut, x = p % kOut;
  // each 32-bit word holds the two horizontally adjacent pixels 2x, 2x+1
  const uint32_t* row0 = reinterpret_cast<const uint32_t*>(
      in + f * kIn * kIn + (2 * y) * kIn);
  const uint32_t ab = __ldg(row0 + x);
  const uint32_t cd = __ldg(row0 + kIn / 2 + x);
  const int r = field_sum(ab, cd, 11, 0x1F) >> 2;
  const int g = field_sum(ab, cd, 5, 0x3F) >> 2;
  const int b = field_sum(ab, cd, 0, 0x1F) >> 2;
  int8_t* o = out + idx * 3;
  o[0] = static_cast<int8_t>((r << 3) - 128);
  o[1] = static_cast<int8_t>((g << 2) - 128);
  o[2] = static_cast<int8_t>((b << 3) - 128);
}

}  // namespace

extern "C" int yf_preprocess_rgb565(const void* frames, void* out, int n,
                                    void* stream) {
  const int threads = 256;
  const long long total = static_cast<long long>(n) * kPix;
  const unsigned blocks =
      static_cast<unsigned>((total + threads - 1) / threads);
  preprocess_rgb565_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(frames), static_cast<int8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
