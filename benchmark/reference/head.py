"""The plain reference of the YOLO head: int8 head tensor -> face boxes.

The benchmark's own copy of the firmware's ``post_process`` as the
serving path states it: dequantize ``(y - zp) * scale`` in float32; rank
the cells by the sigmoid confidence, zeroed below the threshold, in
(anchor, row, col) order with ties to the lowest index; decode the best K
(``cx = (sigmoid(tx) + col) * stride``, ``w = exp(tw) * anchor_w``),
clamp to the frame, and keep a box unless a higher-ranked kept box
overlaps it by more than the IoU threshold (areas with the +1-pixel
convention).  Invalid slots are zero.
"""

from __future__ import annotations

import torch

from .int8 import f32


def sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _iou(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    w = (torch.minimum(x2[..., :, None], x2[..., None, :])
         - torch.maximum(x1[..., :, None], x1[..., None, :]) + 1.0)
    h = (torch.minimum(y2[..., :, None], y2[..., None, :])
         - torch.maximum(y1[..., :, None], y1[..., None, :]) + 1.0)
    inter = w.clamp_min(0.0) * h.clamp_min(0.0)
    return inter / (area[..., :, None] + area[..., None, :] - inter)


@torch.no_grad()
def detect(y: torch.Tensor, *, scale: float, zero_point: int, head: dict):
    """int8 [N,G,G,A*6] -> dict of boxes [N,K,4], scores [N,K], valid
    [N,K] and count [N].  ``head`` holds ``grid``, ``stride``,
    ``anchors``, ``conf_threshold``, ``iou_threshold`` and
    ``max_detections``."""
    n, g = y.shape[0], head["grid"]
    anchors = torch.tensor(head["anchors"], dtype=torch.float32,
                           device=y.device)
    a = anchors.shape[0]
    thr = f32(head["conf_threshold"])
    qf = ((y.to(torch.float32) - zero_point) * f32(scale)).reshape(
        n, g, g, a, 6)
    conf = sigmoid(qf[..., 4].permute(0, 3, 1, 2).reshape(n, -1))
    key = torch.where(conf >= thr, conf, 0.0)
    k = min(head["max_detections"], key.shape[1])
    idx = torch.sort(key, dim=-1, descending=True,
                     stable=True).indices[:, :k]
    anc, cell = idx // (g * g), idx % (g * g)
    rows, cols = cell // g, cell % g
    t = torch.gather(qf.reshape(n, -1, 6), 1,
                     ((rows * g + cols) * a + anc)[..., None].expand(
                         -1, -1, 6))
    cx = (sigmoid(t[..., 0]) + cols.to(torch.float32)) * head["stride"]
    cy = (sigmoid(t[..., 1]) + rows.to(torch.float32)) * head["stride"]
    w = torch.exp(t[..., 2]) * anchors[anc, 0]
    h = torch.exp(t[..., 3]) * anchors[anc, 1]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        -1).clamp(0.0, float(g * head["stride"] - 1))
    score = sigmoid(t[..., 4])
    valid = score >= thr
    iou = _iou(boxes)
    keep = [valid[:, 0]]
    for i in range(1, k):
        over = (iou[:, i, :i] > f32(head["iou_threshold"])) & torch.stack(
            keep, -1)
        keep.append(valid[:, i] & ~over.any(-1))
    valid = torch.stack(keep, -1)
    return {"boxes": torch.where(valid[..., None], boxes, 0.0),
            "scores": torch.where(valid, score, 0.0), "valid": valid,
            "count": valid.sum(-1, dtype=torch.int32)}
