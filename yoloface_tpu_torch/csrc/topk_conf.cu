// Top-K confidence selection of the YOLO head: int8 [N,g,g,a*6] -> int32
// [N,K] flat (anchor,row,col) candidate indices, best first.
//
// Replaces yoloface_tpu/kernels/pallas_head.py::topk_conf_int8, which the
// staged head runs when the fused head is off.  A frame of at most 256
// cells: one warp a frame, kWarpsPerBlock frames a block; a larger frame
// (the 448 family's 9,408 cells): one block a frame.  The selection is
// topk.cuh's (the fused head's own, so the key and the tie rule are the
// same code).  Plain version: kernels/head.py::topk_conf_plain, which the
// card compares bit for bit.
//
// What bounds it on the card: latency of the K = 16 dependent warp
// reductions; it reads 882 bytes (a 448 frame 56,448) and writes 64 a
// frame.  What the design
// does about it: the block ranks the 256 confidences once (topk.cuh's
// table), a lane's candidates are 32-bit integers read from it, each round
// is one redux.sync, and the keys never leave the warp's registers.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

namespace {

// frames a block (a block builds the rank table once; 4 and 8 ran
// 1-3% slower: tools/torch_variant_sweep.py head)
constexpr int kWarpsPerBlock = 16;

__global__ void topk_conf_kernel(const int8_t* __restrict__ y,
                                 int* __restrict__ idx, int n, int g, int a,
                                 int k, float scale, float zp, float thr) {
  __shared__ yf::RankTable table;
  yf::build_rank_table(table, zp, scale, thr);
  const long long frame =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (frame >= n) return;                // whole warps leave together
  const int cells = g * g, c6 = a * 6;
  unsigned key[yf::kKeysPerLane];
  yf::load_keys(y + frame * cells * c6, lane, cells, c6, cells * a, table.hi,
                key);
  const int mine = yf::warp_topk<yf::kKeysPerLane, yf::kWarpIdx>(key, lane,
                                                                  k);
  if (lane < k) idx[frame * k + lane] = mine;
}

__global__ void __launch_bounds__(yf::kBlockThreads)
    topk_conf_block_kernel(const int8_t* __restrict__ y,
                           int* __restrict__ idx, int g, int a, int k,
                           float scale, float zp, float thr) {
  __shared__ yf::RankTable table;
  __shared__ yf::BlockSelect sel;
  yf::build_rank_table(table, zp, scale, thr);
  const long long frame = blockIdx.x;
  const int cells = g * g, c6 = a * 6;
  const int mine = yf::block_topk(y + frame * cells * c6, cells, a, c6, k,
                                  table.hi, sel);
  if (threadIdx.x < k) idx[frame * k + threadIdx.x] = mine;
}

}  // namespace

extern "C" int yf_topk_conf(const void* y, void* idx, int n, int g, int a,
                            int k, float scale, float zp, float thr,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* yy = static_cast<const int8_t*>(y);
  int* out = static_cast<int*>(idx);
  if (g * g * a <= yf::kWarpKeys) {
    const int threads = 32 * kWarpsPerBlock;
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(n) + kWarpsPerBlock - 1) / kWarpsPerBlock);
    topk_conf_kernel<<<blocks, threads, 0, st>>>(yy, out, n, g, a, k, scale,
                                                 zp, thr);
  } else {
    topk_conf_block_kernel<<<static_cast<unsigned>(n), yf::kBlockThreads, 0,
                             st>>>(yy, out, g, a, k, scale, zp, thr);
  }
  return static_cast<int>(cudaGetLastError());
}
