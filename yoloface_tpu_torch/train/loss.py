"""YOLO training loss: the counterpart of ``yoloface_tpu.train.loss``.

Coordinate MSE (sum) on raw tx, ty, tw, th at object cells, weight 5.0;
objectness BCE-with-logits (sum), weight 1.0 at object cells and 0.5 at
no-object cells; class BCE-with-logits (sum) at object cells; the total
over the batch size.  Predictions come NHWC ``[B,G,G,A*6]`` from the
model, targets ``[B,A,G,G,6]``; masked sums, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

LAMBDA_COORD = 5.0
LAMBDA_NOOBJ = 0.5


def _bce_with_logits(logits, labels):
    """Elementwise BCEWithLogits, the numerically-stable log-sum-exp form."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def yolo_loss(predictions: torch.Tensor, targets: torch.Tensor,
              batch: Optional[int] = None) -> torch.Tensor:
    """predictions ``[B,G,G,A*6]`` raw head output; targets
    ``[B,A,G,G,6]`` -> the scalar loss (sum-reduced, over the batch).
    ``batch`` is the divisor (B by default; the global batch for one
    rank's block of a data-parallel step, so the ranks' losses add up to
    the global one)."""
    b, g = predictions.shape[0], predictions.shape[1]
    a = targets.shape[1]
    # anchor-major groups of 6: [B,G,G,A*6] -> [B,A,G,G,6]
    pred = predictions.reshape(b, g, g, a, 6).permute(0, 3, 1, 2, 4)

    obj = (targets[..., 4] == 1.0).to(pred.dtype)       # [B,A,G,G]
    noobj = (targets[..., 4] == 0.0).to(pred.dtype)

    coord_se = torch.square(pred[..., 0:4] - targets[..., 0:4]).sum(-1)
    loss_coord = (coord_se * obj).sum()

    bce_obj = _bce_with_logits(pred[..., 4], targets[..., 4])
    loss_obj = (bce_obj * obj).sum()
    loss_noobj = (bce_obj * noobj).sum()

    bce_cls = _bce_with_logits(pred[..., 5], targets[..., 5])
    loss_cls = (bce_cls * obj).sum()

    total = (LAMBDA_COORD * loss_coord + loss_obj
             + LAMBDA_NOOBJ * loss_noobj + loss_cls)
    return total / (b if batch is None else batch)
