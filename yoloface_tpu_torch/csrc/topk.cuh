// The YOLO head's top-K selection for one frame in one warp, shared by the
// fused head (detect_head.cu, B4) and the top-K-only kernel (topk_conf.cu,
// B5), so the ranking key and the tie rule live in one place.
//
// The ranking key of cell f (flat (anchor,row,col) order, read from the
// (row,col,anchor*6+ch) layout) is the float32 sigmoid of its confidence,
// zeroed below the threshold.  K rounds of a warp argmax on the pair (key
// descending, index ascending) pick the survivors, so sigmoid saturation
// ties go to the lowest flat index as lax.top_k and the Pallas kernels do.
// Plain version: kernels/head.py (rank_key + masked_argmax): expf and the
// division are the IEEE library ones (no fast math), each product and sum
// rounded apart as torch computes them.
#pragma once

#include <cstdint>

namespace yf {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeysPerLane = 8;          // up to 256 cells a frame

__device__ __forceinline__ float sigm(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// Lane `lane`'s keys of frame `y` (cells g*g, c6 = anchors*6 channels):
// key[j] is flat cell lane + 32*j; padding slots sit below every real key.
__device__ __forceinline__ void load_keys(const int8_t* y, int lane,
                                          int cells, int c6, int n_keys,
                                          float zp, float scale, float thr,
                                          float (&key)[kKeysPerLane]) {
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int f = lane + 32 * j;
    key[j] = -2.0f;
    if (f < n_keys) {
      const int an = f / cells, rc = f % cells;
      const float q = static_cast<float>(y[rc * c6 + an * 6 + 4]);
      const float cf = sigm(__fmul_rn(__fsub_rn(q, zp), scale));
      key[j] = cf >= thr ? cf : 0.0f;
    }
  }
}

// K masked-argmax rounds over the warp's keys (consumed); returns, on lane
// kk < k, the flat index of survivor kk (0 on the other lanes).
__device__ __forceinline__ int warp_topk(float (&key)[kKeysPerLane], int lane,
                                         int k) {
  int mine = 0;
  for (int kk = 0; kk < k; ++kk) {
    float best = -3.0f;
    int bi = 1 << 30;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      if (key[j] > best) {               // ascending f: ties keep the lowest
        best = key[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j)
      if (lane + 32 * j == bi) key[j] = -1.0f;
    if (lane == kk) mine = bi;
  }
  return mine;
}

}  // namespace yf
