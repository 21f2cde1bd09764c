"""Training data pipeline: dataset, YOLO target assignment, augmentations.

A numpy copy of ``yoloface_tpu.train.data`` (the port imports nothing of
the JAX package): the reference's ``FaceDataset``
(`yoloface/pytorch/train.py:66-137`) and the TF pipeline's augmentations
(`yoloface/tensorflow/train_tf.py:78-180`) as a host-side iterator of
fixed-shape numpy batches, which the train step moves to its device.
``cv2`` is imported only where an image is decoded or jittered.

Semantics preserved from the reference:
  * labels: normalized [cx, cy, w, h, class]; if an image has no ``.txt``
    sidecar (darknet format), the reference's default centered-face label
    [0.5, 0.5, 0.3, 0.3, 0] is used (train.py:79);
  * target assignment (train.py:102-134): best anchor by IoU of the
    origin-aligned (w, h) boxes; tx, ty are raw cell offsets in [0,1);
    tw, th are log(size/anchor); conf=1, cls=class at the chosen cell;
  * augmentations: horizontal flip (label-aware), HSV jitter, brightness /
    contrast — matching the TF trainer's augment set.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

DEFAULT_ANCHORS = np.array([[9.0, 14.0], [12.0, 17.0], [22.0, 21.0]])


# --------------------------------------------------------------------------
# label IO
# --------------------------------------------------------------------------
def load_labels_for(img_path: str) -> np.ndarray:
    """Darknet-format sidecar labels: ``<cls> <cx> <cy> <w> <h>`` per line,
    normalized.  Falls back to the reference's default centered face."""
    txt = os.path.splitext(img_path)[0] + ".txt"
    if os.path.exists(txt):
        rows = []
        with open(txt) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 5:
                    c, cx, cy, w, h = (float(v) for v in parts[:5])
                    rows.append([cx, cy, w, h, c])
        if rows:
            return np.asarray(rows, np.float64)
    return np.array([[0.5, 0.5, 0.3, 0.3, 0.0]])


# --------------------------------------------------------------------------
# target assignment (exact port of train.py:102-134)
# --------------------------------------------------------------------------
def _wh_iou(wh1, wh2) -> float:
    """IoU of two origin-aligned boxes given (w, h) (train.py:139-160)."""
    inter = min(wh1[0], wh2[0]) * min(wh1[1], wh2[1])
    union = wh1[0] * wh1[1] + wh2[0] * wh2[1] - inter
    return inter / union if union > 0 else 0.0


def build_target(labels: np.ndarray, img_size: int = 56, grid: int = 7,
                 anchors: np.ndarray = DEFAULT_ANCHORS) -> np.ndarray:
    """normalized labels [M,5] -> target [A, G, G, 6]."""
    a = len(anchors)
    target = np.zeros((a, grid, grid, 6), np.float32)
    cell = img_size / grid
    for cx, cy, w, h, cls in labels:
        x_c, y_c = cx * img_size, cy * img_size
        w_px, h_px = w * img_size, h * img_size
        gx = min(int(x_c / cell), grid - 1)
        gy = min(int(y_c / cell), grid - 1)
        tx = x_c / cell - gx
        ty = y_c / cell - gy
        ious = [_wh_iou((w_px, h_px), tuple(anc)) for anc in anchors]
        best = int(np.argmax(ious))
        tw = np.log(max(w_px, 1e-6) / anchors[best, 0])
        th = np.log(max(h_px, 1e-6) / anchors[best, 1])
        target[best, gy, gx] = (tx, ty, tw, th, 1.0, cls)
    return target


# --------------------------------------------------------------------------
# augmentations (host-side numpy; port of train_tf.py:78-180)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AugmentConfig:
    horizontal_flip: bool = True
    hsv_jitter: bool = True
    hue_delta: float = 0.02           # train_tf.py random_hue max_delta
    saturation_range: Tuple[float, float] = (0.8, 1.2)
    brightness_delta: float = 0.15
    contrast_range: Tuple[float, float] = (0.8, 1.2)


def augment(img_rgb_f32: np.ndarray, labels: np.ndarray,
            rng: np.random.Generator,
            cfg: AugmentConfig = AugmentConfig()):
    """img [H,W,3] float in [0,1]; labels normalized [M,5].  Returns both."""
    img = img_rgb_f32
    labels = labels.copy()
    if cfg.horizontal_flip and rng.random() < 0.5:
        img = img[:, ::-1]
        labels[:, 0] = 1.0 - labels[:, 0]
    if cfg.hsv_jitter:
        import cv2
        hsv = cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
        hsv = hsv.astype(np.float32)
        hsv[..., 0] = (hsv[..., 0]
                       + rng.uniform(-cfg.hue_delta, cfg.hue_delta) * 180) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*cfg.saturation_range),
                              0, 255)
        img = cv2.cvtColor(hsv.astype(np.uint8),
                           cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0
    if cfg.brightness_delta:
        img = img + rng.uniform(-cfg.brightness_delta, cfg.brightness_delta)
    if cfg.contrast_range:
        mean = img.mean()
        img = (img - mean) * rng.uniform(*cfg.contrast_range) + mean
    return np.clip(img, 0.0, 1.0), labels


# --------------------------------------------------------------------------
# dataset + batched iterator
# --------------------------------------------------------------------------
class FaceDataset:
    """Image-directory dataset with darknet sidecar labels (or the
    reference's default label), producing (image [56,56,3] f32, target
    [A,7,7,6]) pairs."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, img_dir: str, img_size: int = 56,
                 augment_cfg: Optional[AugmentConfig] = None,
                 anchors: np.ndarray = DEFAULT_ANCHORS):
        self.img_dir = img_dir
        self.img_size = img_size
        self.augment_cfg = augment_cfg
        self.anchors = anchors
        self.files: List[str] = sorted(
            f for f in os.listdir(img_dir)
            if f.lower().endswith(self.EXTS))
        if not self.files:
            raise ValueError(f"no images found in {img_dir}")

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int, rng: Optional[np.random.Generator] = None):
        import cv2
        path = os.path.join(self.img_dir, self.files[idx])
        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"cannot read image: {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (self.img_size, self.img_size))
        img = img.astype(np.float32) / 255.0
        labels = load_labels_for(path)
        if self.augment_cfg is not None and rng is not None:
            img, labels = augment(img, labels, rng, self.augment_cfg)
        target = build_target(labels, self.img_size,
                              anchors=self.anchors)
        return img, target

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 0, drop_remainder: bool = True,
                epochs: Optional[int] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Epoch-aware batched iterator (the tf.data shuffle/batch/prefetch
        analogue, train_tf.py:359-421)."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self))
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order), batch_size):
                idxs = order[i:i + batch_size]
                if drop_remainder and len(idxs) < batch_size:
                    break
                pairs = [self.load(j, rng if self.augment_cfg else None)
                         for j in idxs]
                imgs = np.stack([p[0] for p in pairs])
                tgts = np.stack([p[1] for p in pairs])
                yield imgs, tgts
            epoch += 1
