"""YOLO head kernel wrappers: the fused head and the top-K selection.

``detect_head`` (``csrc/detect_head.cu``) replaces
``yoloface_tpu.kernels.pallas_head.detect_head_fused``: K masked-argmax
rounds over the zeroed-below-threshold sigmoid key (ties to the lowest flat
index in (anchor,row,col) order, though the input is stored
(row,col,anchor*6+ch)), decode of the K survivors, clamp and greedy K^2 NMS
with the +1-pixel IoU.  ``topk_conf`` (``csrc/topk_conf.cu``) replaces
``pallas_head.topk_conf_int8``: the same selection alone, giving the [N,K]
indices the staged head decodes.  Both kernels share the selection code
(``csrc/topk.cuh``); ``detect_head_plain`` and ``topk_conf_plain`` are the
same computations in torch on a batch, and a CPU tensor takes them.

A head of at most ``WARP_KEYS`` cells (grid * grid * anchors: the 7x7x3
corpus head) runs one warp a frame; a larger one, up to ``MAX_KEYS``
(the 448 family's 56x56x3 = 9,408, a darknet head past grid 9), one block
a frame.  The wrappers refuse a head past ``MAX_KEYS`` on the card with
``ValueError``; they never fall back to the plain version there.

This module also holds ``HeadConfig`` and the ranking, decode and NMS steps
that the plain version shares with the staged head of ``pipeline/head.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

WARP_KEYS = 256       # one warp a frame: 8 keys a lane
# one block a frame past WARP_KEYS: a candidate packs rank + 1 (9 bits)
# over 23 bits of index (csrc/topk.cuh, kBlockIdx)
MAX_KEYS = 2 ** 23 - 1
MAX_K = 32            # one survivor a lane
MAX_ANCHORS = 4

DEFAULT_ANCHORS = ((9.0, 14.0), (12.0, 17.0), (22.0, 21.0))


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    grid: int = 7
    stride: int = 8
    anchors: Tuple[Tuple[float, float], ...] = DEFAULT_ANCHORS
    conf_threshold: float = 0.7
    iou_threshold: float = 0.5
    max_detections: int = 16              # fixed-shape NMS capacity
    apply_nms: bool = True
    # rank with the top-K kernel (topk_conf below) instead of a stable
    # sort; only meaningful with use_fused_head=False
    use_pallas_topk: bool = True
    # run top-K + decode + NMS as one kernel (detect_head below)
    use_fused_head: bool = True

    @property
    def num_cells(self) -> int:
        return self.grid * self.grid * len(self.anchors)


def f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``, so a tensor op
    with it is the float32 op whatever precision carries the scalar."""
    return float(np.float32(x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., K, K] with the +1-pixel convention."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = (xx2 - xx1 + 1.0).clamp_min(0.0)
    h = (yy2 - yy1 + 1.0).clamp_min(0.0)
    inter = w * h
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def _greedy_nms(boxes: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """keep[i] = valid[i] and no higher-ranked kept box overlaps it."""
    iou = _iou_matrix(boxes)
    keeps = [valid[:, 0]]
    for i in range(1, valid.shape[1]):
        over = (iou[:, i, :i] > iou_threshold) & torch.stack(keeps, -1)
        keeps.append(valid[:, i] & ~over.any(-1))
    return torch.stack(keeps, -1)


def clamp_boxes(boxes: torch.Tensor, limit: float = 55.0) -> torch.Tensor:
    """Clamp to the frame (limit = grid*stride - 1)."""
    return boxes.clamp(0.0, limit)


def rank_key(y_int8: torch.Tensor, *, scale: float, zero_point: int,
             cfg: HeadConfig = HeadConfig()):
    """(dequantized head [N,G,G,A,6], ranking key [N,C]): the key is the
    zeroed-below-threshold sigmoid confidence in (anchor,row,col) order."""
    n, g, a = y_int8.shape[0], cfg.grid, len(cfg.anchors)
    qf = ((y_int8.to(torch.float32) - zero_point) * f32(scale)
          ).reshape(n, g, g, a, 6)
    conf_all = sigmoid(qf[..., 4].permute(0, 3, 1, 2).reshape(n, -1))
    return qf, torch.where(conf_all >= f32(cfg.conf_threshold), conf_all, 0.0)


def decode_topk(qf: torch.Tensor, top_idx: torch.Tensor,
                cfg: HeadConfig = HeadConfig()):
    """Decode the K ranked candidates ``top_idx`` [N,K] and run greedy NMS
    -> (boxes [N,K,4], scores [N,K], valid [N,K] bool)."""
    n, g, a = qf.shape[0], cfg.grid, len(cfg.anchors)
    cells = g * g
    top_idx = top_idx.long()
    anc = top_idx // cells
    rows = (top_idx % cells) // g
    cols = top_idx % g
    gidx = (rows * g + cols) * a + anc
    t = torch.gather(qf.reshape(n, -1, 6), 1,
                     gidx[..., None].expand(-1, -1, 6))           # [N,K,6]
    anchors = torch.tensor(cfg.anchors, dtype=torch.float32,
                           device=qf.device)
    aw, ah = anchors[anc, 0], anchors[anc, 1]
    cx = (sigmoid(t[..., 0]) + cols.to(torch.float32)) * cfg.stride
    cy = (sigmoid(t[..., 1]) + rows.to(torch.float32)) * cfg.stride
    w = torch.exp(t[..., 2]) * aw
    h = torch.exp(t[..., 3]) * ah
    conf = sigmoid(t[..., 4])
    boxes = clamp_boxes(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                     cy + h / 2], -1),
                        float(cfg.grid * cfg.stride - 1))
    valid = conf >= f32(cfg.conf_threshold)
    if cfg.apply_nms:
        valid = _greedy_nms(boxes, valid, cfg.iou_threshold)
    return (torch.where(valid[..., None], boxes, 0.0),
            torch.where(valid, conf, 0.0), valid)


def masked_argmax(key: torch.Tensor, k: int) -> torch.Tensor:
    """K masked-argmax rounds over ``key`` [N,C] -> int32 [N,K]: each round
    takes the largest key, ties to the lowest index, and masks it to -1."""
    c = key.shape[1]
    flat = torch.arange(c, device=key.device)
    sel = []
    for _ in range(k):
        m = key.max(-1, keepdim=True).values
        s = torch.where(key == m, flat, c).min(-1).values        # lowest idx
        sel.append(s)
        key = torch.where(flat == s[:, None], -1.0, key)
    return torch.stack(sel, -1).to(torch.int32)


def detect_head_plain(y: torch.Tensor, *, scale: float, zero_point: int,
                      cfg: HeadConfig = HeadConfig()):
    """[N,G,G,A*6] int8 -> (boxes [N,K,4] f32, scores [N,K] f32,
    valid [N,K] bool), by K masked-argmax rounds like the kernel."""
    qf, key = rank_key(y, scale=scale, zero_point=zero_point, cfg=cfg)
    k = min(cfg.max_detections, key.shape[1])
    return decode_topk(qf, masked_argmax(key, k), cfg)


def topk_conf_plain(y: torch.Tensor, k: int, *, scale: float,
                    zero_point: int, cfg: HeadConfig = HeadConfig()
                    ) -> torch.Tensor:
    """[N,G,G,A*6] int8 -> int32 [N,K] flat (anchor,row,col) indices of the
    K best candidates by the ranking key, best first."""
    _, key = rank_key(y, scale=scale, zero_point=zero_point, cfg=cfg)
    return masked_argmax(key, k)


def _check_head(y: torch.Tensor, cfg: HeadConfig) -> None:
    g, a = cfg.grid, len(cfg.anchors)
    if y.dim() != 4 or tuple(y.shape[1:]) != (g, g, a * 6):
        raise ValueError(f"expected [N,{g},{g},{a * 6}] head, got "
                         f"{tuple(y.shape)}")
    if y.dtype != torch.int8:
        raise ValueError(f"expected int8 head, got {y.dtype}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no head kernel for device {y.device}")


def topk_conf(y: torch.Tensor, k: int, *, scale: float, zero_point: int,
              cfg: HeadConfig = HeadConfig()) -> torch.Tensor:
    """Top-K kernel; see ``topk_conf_plain`` for the contract."""
    _check_head(y, cfg)
    if y.device.type == "cpu":
        return topk_conf_plain(y, k, scale=scale, zero_point=zero_point,
                               cfg=cfg)
    if cfg.num_cells > MAX_KEYS or not 0 < k <= min(MAX_K, cfg.num_cells):
        raise ValueError(f"top-K kernel takes <= {MAX_KEYS:,} cells and "
                         f"0 < K <= min({MAX_K}, cells), got "
                         f"{cfg.num_cells:,} cells, K = {k}")
    if not y.is_contiguous():
        raise ValueError("head tensor must be contiguous")
    n = y.shape[0]
    idx = torch.empty((n, k), dtype=torch.int32, device=y.device)
    if n == 0:
        return idx
    from yoloface_tpu_torch.kernels._build import check, library
    err = library().yf_topk_conf(
        y.data_ptr(), idx.data_ptr(), n, cfg.grid, len(cfg.anchors), k,
        f32(scale), float(zero_point), f32(cfg.conf_threshold),
        torch.cuda.current_stream(y.device).cuda_stream)
    check(err, "topk_conf")
    topk_conf.launches += 1
    return idx


topk_conf.launches = 0


def detect_head(y: torch.Tensor, *, scale: float, zero_point: int,
                cfg: HeadConfig = HeadConfig()):
    """One-kernel head; see ``detect_head_plain`` for the contract."""
    _check_head(y, cfg)
    g, a = cfg.grid, len(cfg.anchors)
    if y.device.type == "cpu":
        return detect_head_plain(y, scale=scale, zero_point=zero_point,
                                 cfg=cfg)
    k = min(cfg.max_detections, cfg.num_cells)
    if cfg.num_cells > MAX_KEYS or k > MAX_K or a > MAX_ANCHORS:
        raise ValueError(f"head kernel takes <= {MAX_KEYS:,} cells, K <= "
                         f"{MAX_K}, <= {MAX_ANCHORS} anchors, got "
                         f"{cfg.num_cells:,} cells, K = {k}, {a} anchors")
    if not y.is_contiguous():
        raise ValueError("head tensor must be contiguous")
    n = y.shape[0]
    boxes = torch.empty((n, k, 4), dtype=torch.float32, device=y.device)
    scores = torch.empty((n, k), dtype=torch.float32, device=y.device)
    valid = torch.empty((n, k), dtype=torch.bool, device=y.device)
    if n == 0 or k == 0:
        return boxes, scores, valid
    from yoloface_tpu_torch.kernels._build import check, library
    anchors = (ctypes.c_float * (2 * MAX_ANCHORS))(
        *[f32(w) for w, _ in cfg.anchors], *[0.0] * (MAX_ANCHORS - a),
        *[f32(h) for _, h in cfg.anchors], *[0.0] * (MAX_ANCHORS - a))
    err = library().yf_detect_head(
        y.data_ptr(), boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
        n, g, a, k, f32(scale), float(zero_point),
        f32(cfg.conf_threshold), f32(cfg.iou_threshold), f32(cfg.stride),
        f32(cfg.grid * cfg.stride - 1), int(cfg.apply_nms), anchors,
        torch.cuda.current_stream(y.device).cuda_stream)
    check(err, "detect_head")
    detect_head.launches += 1
    return boxes, scores, valid


detect_head.launches = 0
