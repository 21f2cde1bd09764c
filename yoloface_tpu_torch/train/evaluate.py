"""Detection-quality evaluation: IoU-matched precision/recall and AP/mAP.

Port of the reference's evaluation harness
(`yoloface/tensorflow/yolov3_train_tf.py:683-760`: ``calculate_ap`` /
``calculate_map`` with greedy IoU matching, and ``evaluate_model`` :809) and
the report file written by `train_tf.py:976-986`.  A numpy copy of
``yoloface_tpu.train.evaluate``; ``evaluate_pipeline`` runs the port's
``FacePipeline``."""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix [len(a), len(b)] for xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def calculate_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """11-free all-points interpolated AP (yolov3_train_tf.py:683-695)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def match_detections(pred_boxes: np.ndarray, pred_scores: np.ndarray,
                     gt_boxes: np.ndarray, iou_threshold: float = 0.5
                     ) -> Tuple[np.ndarray, int]:
    """Greedy score-ordered matching -> (tp flags per prediction, n_gt)."""
    order = np.argsort(-pred_scores)
    tp = np.zeros(len(pred_boxes), bool)
    used = np.zeros(len(gt_boxes), bool)
    if len(gt_boxes) and len(pred_boxes):
        iou = box_iou(pred_boxes, gt_boxes)
        for i in order:
            j = int(np.argmax(iou[i] * ~used))
            if iou[i, j] >= iou_threshold and not used[j]:
                tp[i] = True
                used[j] = True
    return tp[order], len(gt_boxes)


def calculate_map(predictions: Sequence[Dict], ground_truths: Sequence[Dict],
                  iou_threshold: float = 0.5) -> Dict[str, float]:
    """predictions/ground_truths: per-image dicts with 'boxes' (xyxy) and
    (for predictions) 'scores'.  Returns AP, precision, recall at the
    score-ordered operating sweep (yolov3_train_tf.py:697-760)."""
    all_tp: List[np.ndarray] = []
    all_scores: List[np.ndarray] = []
    n_gt = 0
    for pred, gt in zip(predictions, ground_truths):
        pb = np.asarray(pred.get("boxes", np.zeros((0, 4))), np.float64)
        ps = np.asarray(pred.get("scores", np.zeros((0,))), np.float64)
        gb = np.asarray(gt.get("boxes", np.zeros((0, 4))), np.float64)
        tp, m = match_detections(pb, ps, gb, iou_threshold)
        order = np.argsort(-ps)
        all_tp.append(tp)
        all_scores.append(ps[order])
        n_gt += m
    if not all_tp or n_gt == 0:
        return {"ap": 0.0, "precision": 0.0, "recall": 0.0, "n_gt": n_gt}
    tp = np.concatenate(all_tp)
    scores = np.concatenate(all_scores)
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    ap = calculate_ap(recall, precision)
    return {"ap": ap,
            "precision": float(precision[-1]) if len(precision) else 0.0,
            "recall": float(recall[-1]) if len(recall) else 0.0,
            "n_gt": n_gt}


def evaluate_pipeline(pipeline, dataset, iou_threshold: float = 0.5,
                      report_path: str | None = None) -> Dict[str, float]:
    """Run a FacePipeline over a FaceDataset and compute detection metrics
    against the dataset labels (evaluate_model analogue)."""
    from yoloface_tpu_torch.train.data import load_labels_for
    import os
    preds, gts = [], []
    for i in range(len(dataset)):
        img, _ = dataset.load(i)
        x = np.clip(np.round(img * 255) - 128, -128, 127).astype(np.int8)
        det = pipeline.detect_int8(x[None])
        v = det["valid"][0]
        preds.append({"boxes": det["boxes"][0][v],
                      "scores": det["scores"][0][v]})
        labels = load_labels_for(
            os.path.join(dataset.img_dir, dataset.files[i]))
        s = dataset.img_size
        gb = np.stack([
            (labels[:, 0] - labels[:, 2] / 2) * s,
            (labels[:, 1] - labels[:, 3] / 2) * s,
            (labels[:, 0] + labels[:, 2] / 2) * s,
            (labels[:, 1] + labels[:, 3] / 2) * s], axis=-1)
        gts.append({"boxes": gb})
    metrics = calculate_map(preds, gts, iou_threshold)
    if report_path:
        with open(report_path, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics
