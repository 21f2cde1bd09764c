"""YOLO head in torch: dequantize, grid decode, confidence filter, NMS.

The counterpart of ``yoloface_tpu.pipeline.head``.  Decode constants and
ordering follow the firmware ``post_process`` (grid 7, stride 8, anchors
[9,14] [12,17] [22,21]; cx = (sigmoid+col)*8, w = exp*anchor); NMS is the
fixed-shape greedy K^2 pass with the +1-pixel area convention.

``detect_multihead`` decodes the heads of a multi-head graph (the v3-tiny
FPN) each at its own grid and anchors, pools their candidates and runs one
top-K and greedy NMS across them (``select_detections``), all in torch on
the heads' device: JAX selects with ``lax.top_k`` and an XLA NMS, with no
Pallas kernel.  ``detect_int8_head`` runs either the staged path below
(top-K by the ``topk_conf`` kernel or, with ``use_pallas_topk=False``, by a
stable sort; then gather, decode, NMS) or, with
``HeadConfig.use_fused_head``, the one-kernel head of ``kernels/head.py``.
All rank by the
zeroed-below-threshold float32 sigmoid key with ties to the lowest flat
(anchor,row,col) index, like ``lax.top_k`` and the Pallas kernels in the
JAX package.  ``HeadConfig`` and the ranking, selection, decode and NMS
steps the paths share live in ``kernels/head.py``.

Against the JAX package on the CPU the head agrees up to the last ulp of
``exp``: torch's and XLA's CPU ``exp`` differ by one ulp on 16 to 27 of the
256 int8 inputs (measured for the two scales the tests use), which moves a
box coordinate by an ulp (3.8e-6 px) and a score by at most two; rankings,
validity and counts are equal.  ``BOX_ATOL``/``SCORE_ATOL`` state the
tolerance.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yoloface_tpu_torch.kernels.head import (  # noqa: F401 (re-exported)
    HeadConfig, _greedy_nms, _iou_matrix, clamp_boxes, decode_topk,
    detect_head, f32, rank_key, sigmoid, topk_conf)

# The head's stated tolerance between two exp implementations (torch CPU vs
# XLA CPU in the tests, the card vs the CPU in chip_smoke.py): about 8 ulp
# of the largest box coordinate (55 px) and of a score near 1.0.  Validity,
# counts and the int8 head tensor are held exactly.
BOX_ATOL = 3e-5
SCORE_ATOL = 5e-7


def decode(y_int8: torch.Tensor, *, scale: float, zero_point: int,
           cfg: HeadConfig = HeadConfig()):
    """int8 head [N,G,G,A*6] -> (boxes_xyxy [N,C,4], conf [N,C], cls [N,C]),
    C = G*G*A flattened in (anchor, row, col) order."""
    n, g, a = y_int8.shape[0], cfg.grid, len(cfg.anchors)
    t = (y_int8.to(torch.float32) - zero_point) * f32(scale)
    t = t.reshape(n, g, g, a, 6).permute(0, 3, 1, 2, 4)       # [N,A,G,G,6]
    dev = y_int8.device
    rows = torch.arange(g, dtype=torch.float32, device=dev).reshape(1, 1, g, 1)
    cols = torch.arange(g, dtype=torch.float32, device=dev).reshape(1, 1, 1, g)
    anchors = torch.tensor(cfg.anchors, dtype=torch.float32, device=dev)
    aw = anchors[:, 0].reshape(1, a, 1, 1)
    ah = anchors[:, 1].reshape(1, a, 1, 1)
    cx = (sigmoid(t[..., 0]) + cols) * cfg.stride
    cy = (sigmoid(t[..., 1]) + rows) * cfg.stride
    w = torch.exp(t[..., 2]) * aw
    h = torch.exp(t[..., 3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    c = cfg.num_cells
    return (boxes.reshape(n, c, 4), sigmoid(t[..., 4]).reshape(n, c),
            sigmoid(t[..., 5]).reshape(n, c))


def _top_k(key: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-K with ties to the lowest index (``lax.top_k``)."""
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def select_detections(boxes, conf, cfg: HeadConfig = HeadConfig()):
    """Threshold + top-K + (optional) greedy NMS, all fixed-shape ->
    (boxes [N,K,4], scores [N,K], valid [N,K] bool); invalid slots are 0."""
    k = min(cfg.max_detections, conf.shape[-1])
    scores = torch.where(conf >= f32(cfg.conf_threshold), conf, 0.0)
    top_scores, top_idx = _top_k(scores, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    valid = top_scores > 0.0
    if cfg.apply_nms:
        valid = valid & _greedy_nms(top_boxes, valid, cfg.iou_threshold)
    return (torch.where(valid[..., None], top_boxes, 0.0),
            torch.where(valid, top_scores, 0.0), valid)


def detect_int8_head(y_int8: torch.Tensor, *, scale: float, zero_point: int,
                     cfg: HeadConfig = HeadConfig()):
    """Threshold-first head: rank by the confidence key alone, decode only
    the top K -> (boxes [N,K,4] f32, scores [N,K] f32, valid [N,K] bool)."""
    n, g, a = y_int8.shape[0], cfg.grid, len(cfg.anchors)
    if cfg.use_fused_head:
        return detect_head(y_int8.reshape(n, g, g, a * 6), scale=scale,
                           zero_point=zero_point, cfg=cfg)
    k = min(cfg.max_detections, cfg.num_cells)
    qf, key = rank_key(y_int8, scale=scale, zero_point=zero_point, cfg=cfg)
    if cfg.use_pallas_topk:
        top_idx = topk_conf(y_int8.reshape(n, g, g, a * 6), k, scale=scale,
                            zero_point=zero_point, cfg=cfg)
    else:
        _, top_idx = _top_k(key, k)
    return decode_topk(qf, top_idx, cfg)


def detect_multihead(head_outputs, head_cfgs, *, scales, zero_points,
                     input_size: float, iou_threshold: float = 0.5,
                     conf_threshold: float = 0.7, max_detections: int = 16):
    """Multi-scale YOLO detection: decode each head at its own grid and
    anchors, pool all candidates, one confidence top-K + greedy NMS across
    heads (the counterpart of ``yoloface_tpu.pipeline.head
    .detect_multihead``, for int8 multi-head graphs such as the two-headed
    v3-tiny FPN).

    head_outputs: int8 tensors [N, g_i, g_i, A_i*6] (numpy is taken too),
    all on one device, where the whole head runs;
    head_cfgs:    a HeadConfig (grid, stride, anchors) per head.
    Returns (boxes [N,K,4] f32, scores [N,K] f32, valid [N,K] bool)."""
    all_boxes, all_conf = [], []
    for y, cfg, s, zp in zip(head_outputs, head_cfgs, scales, zero_points):
        b, c, _ = decode(torch.as_tensor(y), scale=float(s),
                         zero_point=int(zp), cfg=cfg)
        all_boxes.append(clamp_boxes(b, limit=input_size - 1.0))
        all_conf.append(c)
    sel_cfg = HeadConfig(conf_threshold=conf_threshold,
                         iou_threshold=iou_threshold,
                         max_detections=max_detections)
    return select_detections(torch.cat(all_boxes, 1), torch.cat(all_conf, 1),
                             sel_cfg)
