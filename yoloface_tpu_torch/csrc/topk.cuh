// The YOLO head's top-K selection for one frame in one warp, shared by the
// fused head (detect_head.cu, B4) and the top-K-only kernel (topk_conf.cu,
// B5), so the ranking key and the tie rule live in one place.
//
// The ranking key of cell f (flat (anchor,row,col) order, read from the
// (row,col,anchor*6+ch) layout) is the float32 sigmoid of its confidence,
// zeroed below the threshold: a function of the cell's int8 confidence q.
// K rounds of a warp argmax on the pair (key descending, index ascending)
// pick the survivors, so sigmoid saturation ties go to the lowest flat
// index as lax.top_k and the Pallas kernels do.  Plain version:
// kernels/head.py (rank_key + masked_argmax): expf and the division are
// the IEEE library ones (no fast math), each product and sum rounded apart
// as torch computes them.
//
// What bounds it on the card: latency, not bytes (a frame is 882 bytes).
// What the design does about it:
//  * the keys come from a table: a block computes the 256 keys once
//    (sigm, the same code the keys took before), then ranks them -- equal
//    keys share a rank, a larger key has a larger rank -- so a lane's
//    candidate is one 32-bit integer, (rank + 1) << 16 | (0xFFFF - f), and
//    no lane computes a key;
//  * a round's warp argmax is one __reduce_max_sync (redux.sync) on those
//    integers instead of 5 dependent shuffle pairs on (float key, index):
//    the larger key wins, and among equal keys the lower f (the larger
//    low half), lax.top_k's tie rule;
//  * the winner is removed by clearing its rank half: a removed slot
//    (0xFFFF - f) sits below every real key and above the padding slots
//    (0), and among removed slots the lowest f wins, as the float form's
//    -1 and -2 keys did.
#pragma once

#include <cstdint>

namespace yf {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeysPerLane = 8;          // up to 256 cells a frame
constexpr int kLevels = 256;             // int8 confidences

__device__ __forceinline__ float sigm(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// A block's tables of the 256 confidences q, at s = q + 128: the ranking
// key, the run starts of equal keys (a bit a level), and hi[s] = (rank +
// 1) << 16, the high half of a candidate.
struct RankTable {
  float key[kLevels];
  unsigned starts[kLevels / 32];
  unsigned hi[kLevels];
};

// Fill `t` for the head's (zp, scale, thr), every thread of the block
// taking part (blockDim.x a multiple of 32), and make it visible.  Where
// the keys do not decrease as q grows (a positive scale: sigm is
// monotone), a level's rank is the first level of its run of equal keys,
// found from the run starts by one ballot a warp and __clz; else the count
// of levels with a smaller key.  Either way equal keys share a rank and a
// larger key has a larger one.
__device__ __forceinline__ void build_rank_table(RankTable& t, float zp,
                                                 float scale, float thr) {
  for (int s = threadIdx.x; s < kLevels; s += blockDim.x) {
    const float q = static_cast<float>(s - 128);
    const float cf = sigm(__fmul_rn(__fsub_rn(q, zp), scale));
    t.key[s] = cf >= thr ? cf : 0.0f;
  }
  __syncthreads();
  int falls = 0;
  for (int s = threadIdx.x; s < kLevels; s += blockDim.x) {   // whole warps
    const bool start = s == 0 || t.key[s - 1] != t.key[s];
    falls |= s > 0 && t.key[s - 1] > t.key[s];
    const unsigned b = __ballot_sync(kFull, start);
    if ((s & 31) == 0) t.starts[s >> 5] = b;
  }
  if (__syncthreads_or(falls)) {
    for (int s = threadIdx.x; s < kLevels; s += blockDim.x) {
      unsigned r = 0;
      for (int w = 0; w < kLevels; ++w) r += t.key[w] < t.key[s] ? 1u : 0u;
      t.hi[s] = (r + 1u) << 16;
    }
  } else {
    for (int s = threadIdx.x; s < kLevels; s += blockDim.x) {
      int w = s >> 5;
      unsigned m = t.starts[w] & (kFull >> (31 - (s & 31)));
      while (m == 0u) m = t.starts[--w];        // level 0 starts a run
      t.hi[s] = static_cast<unsigned>(32 * w + 32 - __clz(m)) << 16;
    }
  }
  __syncthreads();
}

// Lane `lane`'s candidates of frame `y` (cells g*g, c6 = anchors*6
// channels): key[j] is flat cell f = lane + 32*j, (rank + 1) << 16 |
// (0xFFFF - f) from the block's table `hi`; padding slots are 0.  A cell's
// anchor f / cells is one __umulhi by ceil(2**32 / cells) (exact: f * cells
// < 2**32), not a division.
__device__ __forceinline__ void load_keys(const int8_t* y, int lane,
                                          int cells, int c6, int n_keys,
                                          const unsigned* hi,
                                          unsigned (&key)[kKeysPerLane]) {
  const unsigned magic =
      cells > 1 ? 0xffffffffu / static_cast<unsigned>(cells) + 1u : 0u;
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int f = lane + 32 * j;
    key[j] = 0u;
    if (f < n_keys) {
      const int an = cells > 1 ? static_cast<int>(__umulhi(
                                     static_cast<unsigned>(f), magic))
                               : f;
      const int rc = f - an * cells;
      key[j] = hi[y[rc * c6 + an * 6 + 4] + 128] |
               (0xFFFFu - static_cast<unsigned>(f));
    }
  }
}

// K masked-argmax rounds over the warp's candidates (consumed); returns,
// on lane kk < k, the flat index of survivor kk (0 on the other lanes).
__device__ __forceinline__ int warp_topk(unsigned (&key)[kKeysPerLane],
                                         int lane, int k) {
  int mine = 0;
  for (int kk = 0; kk < k; ++kk) {
    unsigned best = key[0];
#pragma unroll
    for (int j = 1; j < kKeysPerLane; ++j) best = max(best, key[j]);
    best = __reduce_max_sync(kFull, best);
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j)
      if (key[j] == best) key[j] &= 0xFFFFu;   // removed: below every key
    if (lane == kk) mine = static_cast<int>(0xFFFFu - (best & 0xFFFFu));
  }
  return mine;
}

}  // namespace yf
