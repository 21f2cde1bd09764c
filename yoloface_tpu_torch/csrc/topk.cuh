// The YOLO head's top-K selection, shared by the fused head
// (detect_head.cu, B4) and the top-K-only kernel (topk_conf.cu, B5), so the
// ranking key and the tie rule live in one place.  Two paths: a frame of
// at most kWarpKeys cells in one warp (warp_topk, 16 frames a block), and
// a larger frame in one block (block_topk, up to kBlockIdx cells).
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
// What bounds it on the card: latency, not bytes (a 7x7 frame is 882
// bytes).  What the design does about it:
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
//
// A larger frame (the 448 family's 56x56x3 = 9,408 cells) is selected by
// counting, in O(cells) and not K x cells, since a cell's rank is one of
// 256 levels: the block counts the cells of each rank, finds the level R
// such that fewer than K cells rank above it and at least K at or above
// it, takes every cell above R and the lowest-index cells at R up to K
// (an index-ordered pass over the frame that stops once it has K), and
// one warp orders those K with warp_topk on one candidate a lane, the
// candidate now (rank + 1) << 23 | (kBlockIdx - f): rank + 1 takes 9 bits,
// f up to 23, so a frame may hold kBlockIdx = 8,388,607 cells.  No anchor
// division: the passes walk anchors outside, cells inside.
#pragma once

#include <cstdint>

namespace yf {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeysPerLane = 8;          // up to 256 cells a frame
constexpr int kWarpKeys = 32 * kKeysPerLane;
constexpr int kLevels = 256;             // int8 confidences
constexpr unsigned kWarpIdx = 0xFFFFu;   // index bits of a warp candidate
// the block path's index bits of a candidate: a frame holds at most
// kBlockIdx cells, so a removed candidate, kBlockIdx - f, stays above the
// padding 0 (kernels/head.py MAX_KEYS)
constexpr unsigned kBlockIdx = 0x7FFFFFu;
constexpr int kBlockThreads = 256;       // the block path's threads

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

// K masked-argmax rounds over the warp's candidates (consumed), kN a lane,
// each with kIdx - f in its low bits kIdx; returns, on lane kk < k, the
// flat index of survivor kk (0 on the other lanes).
template <int kN, unsigned kIdx>
__device__ __forceinline__ int warp_topk(unsigned (&key)[kN], int lane,
                                         int k) {
  int mine = 0;
  for (int kk = 0; kk < k; ++kk) {
    unsigned best = key[0];
#pragma unroll
    for (int j = 1; j < kN; ++j) best = max(best, key[j]);
    best = __reduce_max_sync(kFull, best);
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (key[j] == best) key[j] &= kIdx;      // removed: below every key
    if (lane == kk) mine = static_cast<int>(kIdx - (best & kIdx));
  }
  return mine;
}

// The block path's shared scratch.
struct BlockSelect {
  unsigned count[kLevels];                 // cells a rank
  unsigned warp_at[kBlockThreads / 32];    // a chunk's cells at the level
  unsigned cand[32];                       // the K survivors, unordered
  unsigned n_cand, level, need;
};

// Rank + 1 (1..256) of confidence q from the table's high halves.
__device__ __forceinline__ unsigned rank1(const unsigned* hi, int8_t q) {
  return hi[q + 128] >> 16;
}

// The top K (K <= 32) of a frame of cells * a candidates (cells g*g, c6 =
// a*6 channels) in a block of kBlockThreads; returns, on lane kk < k of
// warp 0, the flat index of survivor kk (0 elsewhere).  Every thread of
// the block calls it; `hi` is the block's rank table.
__device__ __forceinline__ int block_topk(const int8_t* __restrict__ y,
                                          int cells, int a, int c6, int k,
                                          const unsigned* hi, BlockSelect& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kBlockThreads / 32;
  for (int i = tid; i < kLevels; i += kBlockThreads) s.count[i] = 0u;
  if (tid == 0) s.n_cand = 0u;
  __syncthreads();
  // 1. the cells of each rank: a warp's lanes on one rank add once
  for (int base = warp * 32; base < cells; base += kBlockThreads) {
    const int rc = base + lane;
    const int8_t* cell = y + static_cast<long long>(rc) * c6 + 4;
    for (int an = 0; an < a; ++an) {
      const unsigned r = rc < cells ? rank1(hi, cell[6 * an]) - 1u : ~0u;
      const unsigned peers = __match_any_sync(kFull, r);
      if (r != ~0u && __ffs(peers) - 1 == lane)
        atomicAdd(&s.count[r], static_cast<unsigned>(__popc(peers)));
    }
  }
  __syncthreads();
  // 2. the level: rank + 1 = L with cells(rank + 1 > L) < k <=
  // cells(rank + 1 >= L); lane l holds ranks 8l .. 8l + 7
  if (warp == 0) {
    unsigned c[8], sum = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = s.count[8 * lane + j];
      sum += c[j];
    }
    unsigned above = sum;                  // cells of this lane and up
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned v = __shfl_down_sync(kFull, above, d);
      if (lane + d < 32) above += v;
    }
    above -= sum;                          // cells of the lanes above
    const unsigned kk = static_cast<unsigned>(k);
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (above < kk && above + c[j] >= kk) {
        s.level = static_cast<unsigned>(8 * lane + j + 1);
        s.need = kk - above;
      }
      above += c[j];
    }
  }
  __syncthreads();
  // 3. every cell above the level and the `need` lowest-index cells at
  // it, chunk by chunk in flat index order, until K are taken
  const unsigned level = s.level, need = s.need;
  unsigned at_before = 0u;                 // cells at the level so far
  bool done = false;
  for (int an = 0; an < a && !done; ++an) {
    for (int base = 0; base < cells && !done; base += kBlockThreads) {
      const int rc = base + tid;
      const unsigned r1 =
          rc < cells ? rank1(hi, y[static_cast<long long>(rc) * c6 + an * 6 +
                                   4])
                     : 0u;
      const bool at = r1 == level;
      const unsigned b = __ballot_sync(kFull, at);
      if (lane == 0) s.warp_at[warp] = static_cast<unsigned>(__popc(b));
      __syncthreads();
      unsigned before = at_before + __popc(b & ((1u << lane) - 1u)), all = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? s.warp_at[w] : 0u;
        all += s.warp_at[w];
      }
      if (r1 > level || (at && before < need)) {
        const unsigned f = static_cast<unsigned>(an * cells + rc);
        s.cand[atomicAdd(&s.n_cand, 1u)] = r1 << 23 | (kBlockIdx - f);
      }
      at_before += all;
      __syncthreads();
      done = s.n_cand == static_cast<unsigned>(k);
    }
  }
  // 4. order the K in warp 0, one a lane
  if (warp != 0) return 0;
  unsigned key[1] = {lane < k ? s.cand[lane] : 0u};
  return warp_topk<1, kBlockIdx>(key, lane, k);
}

}  // namespace yf
