// The whole YOLO head in one kernel: top-K, decode and greedy NMS.
//
// Replaces yoloface_tpu/kernels/pallas_head.py::detect_head_fused.  A
// frame of at most 256 cells: one warp a frame, kWarpsPerBlock frames a
// block.  The top-K selection (ranking key and tie rule) is the shared one
// of topk.cuh: the block builds the confidences' rank table once, each
// lane reads its 8 candidates from it, and each of the K rounds is one
// redux.sync.  A larger frame (the 448 family's 9,408 cells): one block a
// frame, the selection by counting of topk.cuh's block_topk.  Either way
// lane k of one warp then decodes survivor k, and NMS walks the K
// candidates in rank order with one ballot each.  Plain version: kernels/head.py::
// detect_head_plain, which the card compares bit for bit: expf and the
// float divisions are the IEEE library ones (no fast math), each product
// and sum rounded apart as torch computes them.
//
// What bounds it on the card: latency of the K = 16 dependent warp
// reductions, of the decode's expf and divisions and of the NMS's 15
// ballots; it reads 882 bytes (a 448 frame 56,448) and writes 336 a
// frame.  What the design
// does about it: a frame never leaves its warp's registers, no lane
// computes a ranking key (the table), a round of the top-K is one
// instruction across the warp, and several frames share a block (and its
// table), so enough warps are resident to hide the latency.
#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

namespace {

using yf::kFull;
using yf::sigm;
// frames a block (a block builds the rank table once; 4 and 8 ran
// 1-3% slower: tools/torch_variant_sweep.py head)
constexpr int kWarpsPerBlock = 16;

struct Anchors {
  float w[4], h[4];
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// What a launch decodes with.
struct HeadArgs {
  int g, a, k;
  float scale, zp, thr, iou_thr, stride, lim;
  int apply_nms;
  Anchors anc;
};

// Lane kk < k of one warp holds survivor kk's flat index `mine` of frame
// `yq`: decode it, run greedy NMS across the warp, store slot kk.
__device__ __forceinline__ void decode_nms_store(const int8_t* yq, int lane,
                                                 int mine, long long frame,
                                                 const HeadArgs& h,
                                                 float* __restrict__ boxes,
                                                 float* __restrict__ scores,
                                                 bool* __restrict__ valid) {
  const int g = h.g, k = h.k, cells = g * g, c6 = h.a * 6;
  const float zp = h.zp, scale = h.scale, lim = h.lim;
  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, cf = 0.f;
  bool keep = false;
  if (lane < k) {
    const int an = mine / cells, rc = mine % cells;
    const int row = rc / g, col = rc % g;
    const int8_t* cell = yq + static_cast<long long>(rc) * c6 + an * 6;
    float t[6];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch)
      t[ch] = __fmul_rn(__fsub_rn(static_cast<float>(cell[ch]), zp), scale);
    const float cx = __fmul_rn(__fadd_rn(sigm(t[0]), static_cast<float>(col)),
                               h.stride);
    const float cy = __fmul_rn(__fadd_rn(sigm(t[1]), static_cast<float>(row)),
                               h.stride);
    const float w = __fmul_rn(expf(t[2]), h.anc.w[an]);
    const float hh0 = __fmul_rn(expf(t[3]), h.anc.h[an]);
    cf = sigm(t[4]);
    const float hw = __fdiv_rn(w, 2.0f), hh = __fdiv_rn(hh0, 2.0f);
    x1 = clampf(__fsub_rn(cx, hw), 0.0f, lim);
    y1 = clampf(__fsub_rn(cy, hh), 0.0f, lim);
    x2 = clampf(__fadd_rn(cx, hw), 0.0f, lim);
    y2 = clampf(__fadd_rn(cy, hh), 0.0f, lim);
    keep = cf >= h.thr;
  }

  if (h.apply_nms) {
    const float area = __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                                 __fadd_rn(__fsub_rn(y2, y1), 1.0f));
    for (int i = 1; i < k; ++i) {
      const float bx1 = __shfl_sync(kFull, x1, i);
      const float by1 = __shfl_sync(kFull, y1, i);
      const float bx2 = __shfl_sync(kFull, x2, i);
      const float by2 = __shfl_sync(kFull, y2, i);
      const float barea = __shfl_sync(kFull, area, i);
      bool over = false;
      if (lane < i) {
        const float xx1 = fmaxf(bx1, x1), yy1 = fmaxf(by1, y1);
        const float xx2 = fminf(bx2, x2), yy2 = fminf(by2, y2);
        const float iw = fmaxf(0.0f, __fadd_rn(__fsub_rn(xx2, xx1), 1.0f));
        const float ih = fmaxf(0.0f, __fadd_rn(__fsub_rn(yy2, yy1), 1.0f));
        const float inter = __fmul_rn(iw, ih);
        const float iou =
            __fdiv_rn(inter, __fsub_rn(__fadd_rn(barea, area), inter));
        over = iou > h.iou_thr && keep;
      }
      const unsigned any = __ballot_sync(kFull, over);
      if (lane == i) keep = keep && any == 0u;
    }
  }

  if (lane < k) {
    const long long o = frame * k + lane;
    boxes[o * 4 + 0] = keep ? x1 : 0.0f;
    boxes[o * 4 + 1] = keep ? y1 : 0.0f;
    boxes[o * 4 + 2] = keep ? x2 : 0.0f;
    boxes[o * 4 + 3] = keep ? y2 : 0.0f;
    scores[o] = keep ? cf : 0.0f;
    valid[o] = keep;
  }
}

// At most 256 cells a frame: one warp a frame.
__global__ void detect_head_kernel(const int8_t* __restrict__ y,
                                   float* __restrict__ boxes,
                                   float* __restrict__ scores,
                                   bool* __restrict__ valid, int n,
                                   HeadArgs h) {
  __shared__ yf::RankTable table;
  yf::build_rank_table(table, h.zp, h.scale, h.thr);
  const long long frame =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (frame >= n) return;                // whole warps leave together
  const int cells = h.g * h.g, c6 = h.a * 6, n_keys = cells * h.a;
  const int8_t* yq = y + frame * cells * c6;  // this frame

  unsigned key[yf::kKeysPerLane];
  yf::load_keys(yq, lane, cells, c6, n_keys, table.hi, key);
  // lane kk: survivor kk
  const int mine = yf::warp_topk<yf::kKeysPerLane, yf::kWarpIdx>(key, lane,
                                                                  h.k);
  decode_nms_store(yq, lane, mine, frame, h, boxes, scores, valid);
}

// More than 256 cells a frame: one block a frame, warp 0 decodes.
__global__ void __launch_bounds__(yf::kBlockThreads)
    detect_head_block_kernel(const int8_t* __restrict__ y,
                             float* __restrict__ boxes,
                             float* __restrict__ scores,
                             bool* __restrict__ valid, HeadArgs h) {
  __shared__ yf::RankTable table;
  __shared__ yf::BlockSelect sel;
  yf::build_rank_table(table, h.zp, h.scale, h.thr);
  const long long frame = blockIdx.x;
  const int cells = h.g * h.g, c6 = h.a * 6;
  const int8_t* yq = y + frame * cells * c6;
  const int mine = yf::block_topk(yq, cells, h.a, c6, h.k, table.hi, sel);
  if (threadIdx.x >= 32) return;
  decode_nms_store(yq, threadIdx.x, mine, frame, h, boxes, scores, valid);
}

}  // namespace

extern "C" int yf_detect_head(const void* y, void* boxes, void* scores,
                              void* valid, int n, int g, int a, int k,
                              float scale, float zp, float thr, float iou_thr,
                              float stride, float box_limit, int apply_nms,
                              const void* host_anchors, void* stream) {
  Anchors anc = {};
  const float* ha = static_cast<const float*>(host_anchors);
  for (int i = 0; i < 4; ++i) {
    anc.w[i] = ha[i];
    anc.h[i] = ha[4 + i];
  }
  const HeadArgs h = {g, a, k, scale, zp, thr, iou_thr, stride, box_limit,
                      apply_nms, anc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* yy = static_cast<const int8_t*>(y);
  float* b = static_cast<float*>(boxes);
  float* s = static_cast<float*>(scores);
  bool* v = static_cast<bool*>(valid);
  if (g * g * a <= yf::kWarpKeys) {
    const int threads = 32 * kWarpsPerBlock;
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(n) + kWarpsPerBlock - 1) / kWarpsPerBlock);
    detect_head_kernel<<<blocks, threads, 0, st>>>(yy, b, s, v, n, h);
  } else {
    detect_head_block_kernel<<<static_cast<unsigned>(n), yf::kBlockThreads,
                               0, st>>>(yy, b, s, v, h);
  }
  return static_cast<int>(cudaGetLastError());
}
