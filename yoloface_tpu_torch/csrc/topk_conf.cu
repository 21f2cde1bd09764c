// Top-K confidence selection of the YOLO head: int8 [N,g,g,a*6] -> int32
// [N,K] flat (anchor,row,col) candidate indices, best first.
//
// Replaces yoloface_tpu/kernels/pallas_head.py::topk_conf_int8, which the
// staged head runs when the fused head is off.  One warp a frame, the
// selection of topk.cuh (the fused head's own, so the key and the tie rule
// are the same code).  Plain version: kernels/head.py::topk_conf_plain,
// which the card compares bit for bit.
//
// What bounds it on the card: latency of the K = 16 dependent warp
// reductions (5 shuffles each) after 147 expf a frame; it reads 882 bytes
// and writes 64 a frame.  What the design does about it: the keys never
// leave the warp's registers, and four frames share a block, so enough
// warps are resident to hide the shuffle latency.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void topk_conf_kernel(const int8_t* __restrict__ y,
                                 int* __restrict__ idx, int n, int g, int a,
                                 int k, float scale, float zp, float thr) {
  const long long frame =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (frame >= n) return;                // whole warps leave together
  const int cells = g * g, c6 = a * 6;
  float key[yf::kKeysPerLane];
  yf::load_keys(y + frame * cells * c6, lane, cells, c6, cells * a, zp, scale,
                thr, key);
  const int mine = yf::warp_topk(key, lane, k);
  if (lane < k) idx[frame * k + lane] = mine;
}

}  // namespace

extern "C" int yf_topk_conf(const void* y, void* idx, int n, int g, int a,
                            int k, float scale, float zp, float thr,
                            void* stream) {
  const int threads = 32 * kWarpsPerBlock;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(n) + kWarpsPerBlock - 1) /
                            kWarpsPerBlock);
  topk_conf_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(y), static_cast<int*>(idx), n, g, a, k, scale,
      zp, thr);
  return static_cast<int>(cudaGetLastError());
}
