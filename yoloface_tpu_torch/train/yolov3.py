"""YOLOv3-style training variant: 416x416, the v3 loss, mosaic, multiscale.

The counterpart of ``yoloface_tpu.train.yolov3`` (the reference's larger
trainer, `yoloface/tensorflow/yolov3_train_tf.py`):

  * config (:22-57): 416 input, the 9 YOLOv3 anchors with the first 3
    selected, AdamW (optax's ``adamw``, no clipping) on
    ``warmup_cosine_decay_schedule``, multiscale 320..608, mosaic;
  * the v3 loss (:349-477): sigmoid-xy MSE, sqrt-balanced wh, IoU as the
    confidence target with hard-negative mining (no-object only where
    IoU < 0.5), a squared-error class term, over the object count;
  * mosaic augmentation (:108-162), random rotation (:521) and crop
    (:549), numpy with ``cv2`` imported inside the function, as JAX does;
  * multiscale training (:299-347): the image size drawn per epoch in
    [320, 608] at stride 32.

The model is the port's fully-convolutional ``YoloFace`` in training mode
(Flax's BN: batch statistics, running statistics moved): at img_size S
the head is an (S/8)x(S/8) grid.  The step runs float32 with TF32 off
(``core.precision.full_f32``) on the card unless ``device`` says
otherwise; the trainer draws its batches with numpy from its seed in
JAX's order, so the same seed gives JAX's scales and batches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from yoloface_tpu_torch.core.precision import device_or_raise, full_f32
from yoloface_tpu_torch.models.yoloface import YoloFace
from yoloface_tpu_torch.train import steps

YOLOV3_ANCHORS = np.array([
    [10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119],
    [116, 90], [156, 198], [373, 326]], np.float32)


@dataclasses.dataclass
class YoloV3Config:
    img_size: int = 416
    num_anchors: int = 3
    batch_size: int = 16
    epochs: int = 100
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    warmup_epochs: int = 3
    multiscale: bool = True
    multiscale_min: int = 320
    multiscale_max: int = 608
    mosaic: bool = True
    rotate: bool = True      # random_rotate aug (yolov3_train_tf.py:521)
    crop: bool = True        # random_crop aug (yolov3_train_tf.py:549)
    rotate_prob: float = 0.5
    crop_prob: float = 0.5
    stride: int = 8
    # the schedule advances per optimizer update; its warmup and decay
    # horizons are epochs * steps_per_epoch steps (keep in step with the
    # steps_per_epoch given to YoloV3Trainer.fit)
    steps_per_epoch: int = 4

    @property
    def anchors(self) -> np.ndarray:
        return YOLOV3_ANCHORS[:self.num_anchors]

    @property
    def grid_size(self) -> int:
        return self.img_size // self.stride

    def sample_scale(self, rng: np.random.Generator) -> int:
        """Multiscale: a stride-32 size in [min, max] (:306-315)."""
        if not self.multiscale:
            return self.img_size
        lo = self.multiscale_min // 32
        hi = self.multiscale_max // 32
        return int(rng.integers(lo, hi + 1)) * 32


# --------------------------------------------------------------------------
# loss (YoloV3Loss.call, :374-436)
# --------------------------------------------------------------------------
def _decode_boxes(xy, wh, grid, grid_size, anchors):
    xy = (xy + grid) / grid_size
    wh = torch.exp(wh) * anchors / grid_size
    return torch.cat([xy - wh / 2, xy + wh / 2], -1)


def _iou(b1, b2):
    x1 = torch.maximum(b1[..., 0:1], b2[..., 0:1])
    y1 = torch.maximum(b1[..., 1:2], b2[..., 1:2])
    x2 = torch.minimum(b1[..., 2:3], b2[..., 2:3])
    y2 = torch.minimum(b1[..., 3:4], b2[..., 3:4])
    zero = x1.new_zeros(())       # jnp.maximum's half gradient at a tie
    inter = torch.maximum(x2 - x1, zero) * torch.maximum(y2 - y1, zero)
    a1 = (b1[..., 2:3] - b1[..., 0:1]) * (b1[..., 3:4] - b1[..., 1:2])
    a2 = (b2[..., 2:3] - b2[..., 0:1]) * (b2[..., 3:4] - b2[..., 1:2])
    return inter / (a1 + a2 - inter + 1e-10)


def _signed_sqrt(v):
    return torch.sign(v) * torch.sqrt(torch.abs(v) + 1e-10)


def yolov3_loss(y_pred: torch.Tensor, y_true: torch.Tensor, anchors,
                grid_size: int, lambda_coord: float = 5.0,
                lambda_noobj: float = 0.5, lambda_class: float = 1.0
                ) -> torch.Tensor:
    """y_pred [B,G,G,A*6] raw head output; y_true [B,G,G,A,6] with
    sigmoid-space xy targets, log-space wh, conf, class -> scalar loss."""
    b = y_pred.shape[0]
    anchors = torch.as_tensor(np.asarray(anchors, np.float32),
                              device=y_pred.device)
    a = anchors.shape[0]
    pred = y_pred.reshape(b, grid_size, grid_size, a, 6)

    r = torch.arange(grid_size, dtype=torch.float32, device=y_pred.device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(1, grid_size, grid_size, 1, 2)
    anchors = anchors.reshape(1, 1, 1, a, 2)

    pred_xy = torch.sigmoid(pred[..., :2])
    pred_wh = pred[..., 2:4]
    pred_conf = torch.sigmoid(pred[..., 4:5])
    pred_class = torch.sigmoid(pred[..., 5:6])

    obj = y_true[..., 4:5]
    noobj = 1.0 - obj

    # the signed-sqrt smoothing on both sides of the wh term (the
    # reference's bare sqrt of a log-space target NaNs below the anchor)
    coord_loss = lambda_coord * (
        (obj * torch.square(pred_xy - y_true[..., :2])).sum()
        + (obj * torch.square(_signed_sqrt(pred_wh)
                              - _signed_sqrt(y_true[..., 2:4]))).sum())

    pred_boxes = _decode_boxes(pred_xy, pred_wh, grid, grid_size, anchors)
    true_boxes = _decode_boxes(y_true[..., :2], y_true[..., 2:4], grid,
                               grid_size, anchors)
    iou = _iou(pred_boxes, true_boxes)

    obj_conf_loss = (obj * torch.square(pred_conf - iou)).sum()
    hard_noobj = noobj * (iou < 0.5).to(pred.dtype)
    noobj_conf_loss = lambda_noobj * (hard_noobj
                                      * torch.square(pred_conf)).sum()
    class_loss = lambda_class * (obj * torch.square(
        pred_class - y_true[..., 5:6])).sum()

    total = coord_loss + obj_conf_loss + noobj_conf_loss + class_loss
    return total / torch.clamp(obj.sum(), min=1.0)


# --------------------------------------------------------------------------
# augmentation (numpy; :108-162, :521-575)
# --------------------------------------------------------------------------
def mosaic_augmentation(images, labels_list, img_size: int,
                        rng: np.random.Generator):
    """4 images (uint8/float RGB) + normalized [cls,cx,cy,w,h] labels ->
    one mosaic canvas + merged labels (same layout)."""
    import cv2
    mosaic = np.zeros((img_size, img_size, 3), images[0].dtype)
    xc = int(rng.integers(img_size // 4, img_size * 3 // 4 + 1))
    yc = int(rng.integers(img_size // 4, img_size * 3 // 4 + 1))
    quads = [(0, 0, xc, yc), (xc, 0, img_size - xc, yc),
             (0, yc, xc, img_size - yc), (xc, yc, img_size - xc,
                                          img_size - yc)]
    merged = []
    for (ox, oy, w, h), img, labels in zip(quads, images, labels_list):
        if w == 0 or h == 0:
            continue
        mosaic[oy:oy + h, ox:ox + w] = cv2.resize(img, (w, h))
        if len(labels):
            lab = np.asarray(labels, np.float64).copy()
            # normalized coords within the quad -> canvas-normalized
            lab[:, 1] = (lab[:, 1] * w + ox) / img_size
            lab[:, 2] = (lab[:, 2] * h + oy) / img_size
            lab[:, 3] = lab[:, 3] * w / img_size
            lab[:, 4] = lab[:, 4] * h / img_size
            keep = ((lab[:, 1] > 0) & (lab[:, 1] < 1)
                    & (lab[:, 2] > 0) & (lab[:, 2] < 1))
            merged.append(lab[keep])
    labels_out = (np.concatenate(merged, 0) if merged
                  else np.zeros((0, 5)))
    return mosaic, labels_out


def random_rotate(img, labels, rng: np.random.Generator,
                  angle_range=(-10.0, 10.0)):
    """Label-aware random rotation: the image about its center, the label
    centers through the same affine (w and h stay axis-aligned, as in the
    reference), layout [cls,cx,cy,w,h] normalized."""
    import cv2
    angle = float(rng.uniform(*angle_range))
    h, w = img.shape[:2]
    M = cv2.getRotationMatrix2D((w // 2, h // 2), angle, 1.0)
    out = cv2.warpAffine(img, M, (w, h), flags=cv2.INTER_CUBIC,
                         borderMode=cv2.BORDER_CONSTANT)
    labels = np.asarray(labels, np.float64).reshape(-1, 5).copy()
    if len(labels):
        centers = np.stack([labels[:, 1] * w, labels[:, 2] * h], -1)
        rot = cv2.transform(centers[None].astype(np.float32), M)[0]
        labels[:, 1] = rot[:, 0] / w
        labels[:, 2] = rot[:, 1] / h
        keep = ((labels[:, 1] > 0) & (labels[:, 1] < 1)
                & (labels[:, 2] > 0) & (labels[:, 2] < 1))
        labels = labels[keep]
    return out, labels


def random_crop(img, labels, rng: np.random.Generator,
                min_size: float = 0.3, max_size: float = 1.0):
    """Label-aware random crop: a random square fraction, labels rescaled
    into it, those whose centers fall outside dropped."""
    h, w = img.shape[:2]
    frac = float(rng.uniform(min_size, max_size))
    ch, cw = max(1, int(h * frac)), max(1, int(w * frac))
    y1 = int(rng.integers(0, h - ch + 1))
    x1 = int(rng.integers(0, w - cw + 1))
    out = img[y1:y1 + ch, x1:x1 + cw]
    labels = np.asarray(labels, np.float64).reshape(-1, 5).copy()
    if len(labels):
        labels[:, 1] = (labels[:, 1] * w - x1) / cw
        labels[:, 2] = (labels[:, 2] * h - y1) / ch
        labels[:, 3] = labels[:, 3] * w / cw
        labels[:, 4] = labels[:, 4] * h / ch
        keep = ((labels[:, 1] > 0) & (labels[:, 1] < 1)
                & (labels[:, 2] > 0) & (labels[:, 2] < 1)
                & (labels[:, 3] > 0) & (labels[:, 4] > 0))
        labels = labels[keep]
    return out, labels


def build_v3_target(labels_cxcywh_cls, cfg: YoloV3Config) -> np.ndarray:
    """Normalized [cls,cx,cy,w,h] rows -> [G,G,A,6] v3-style target
    (sigmoid-space xy offsets, log-space wh against the anchor, conf,
    class)."""
    g = cfg.grid_size
    a = cfg.num_anchors
    anchors = cfg.anchors
    target = np.zeros((g, g, a, 6), np.float32)
    for cls, cx, cy, w, h in labels_cxcywh_cls:
        gx = min(int(cx * g), g - 1)
        gy = min(int(cy * g), g - 1)
        tx = cx * g - gx
        ty = cy * g - gy
        w_px, h_px = w * cfg.img_size, h * cfg.img_size
        ious = []
        for aw, ah in anchors:
            inter = min(w_px, aw) * min(h_px, ah)
            union = w_px * h_px + aw * ah - inter
            ious.append(inter / union if union else 0.0)
        best = int(np.argmax(ious))
        tw = np.log(max(w_px, 1e-6) / anchors[best, 0])
        th = np.log(max(h_px, 1e-6) / anchors[best, 1])
        target[gy, gx, best] = (tx, ty, tw, th, 1.0, cls)
    return target


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
def make_v3_schedule(cfg: YoloV3Config):
    """The step count -> the float32 rate: optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup_epochs * spe,
    max(epochs, warmup_epochs + 1) * spe)``."""
    spe = max(1, cfg.steps_per_epoch)
    return steps.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_epochs * spe,
        max(cfg.epochs, cfg.warmup_epochs + 1) * spe)


def make_v3_train_step(cfg: YoloV3Config, model: Optional[YoloFace] = None,
                       device="cuda"):
    """(init, step): ``init(generator, img_size=None)`` -> the state
    ``{"model", "opt_state", "step"}`` on ``device`` (a new ``YoloFace``
    drawn from ``generator``, a ``torch.Generator`` or a seed, unless
    ``model`` is given); ``step(state, images, targets) -> (state,
    {"loss"})`` in training mode, the state updated in place.  Any image
    size a multiple of 8 (the grid is the size over the stride)."""
    device = device_or_raise(device, "make_v3_train_step")
    schedule = make_v3_schedule(cfg)
    anchors = cfg.anchors

    def init(generator=None, img_size=None):
        m = model
        if m is None:
            if not isinstance(generator, torch.Generator):
                generator = torch.Generator().manual_seed(
                    int(generator or 0))
            m = YoloFace(generator)
        m = m.to(device)
        with torch.no_grad():
            opt_state = steps.adam_init(steps._flat(m.parameters()))
        return {"model": m, "opt_state": opt_state, "step": 0}

    def step(state, images, targets):
        m = state["model"]
        params = list(m.parameters())
        x = steps._batch(images, device)
        t = steps._batch(targets, device)
        g = x.shape[1] // cfg.stride
        m.train()
        with full_f32():
            loss = yolov3_loss(m(x), t, anchors, g)
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            opt = state["opt_state"]
            u, state["opt_state"] = steps.adam_update(
                steps._flat(grads), opt, schedule(opt["count"]),
                steps._flat(params), cfg.weight_decay)
            steps.add_flat_(params, u)
        state["step"] += 1
        return state, {"loss": loss.detach()}

    return init, step


class YoloV3Trainer:
    """Multiscale + mosaic training loop (yolov3_train_tf.py:299-347,
    583-655): each epoch draws a stride-32 image size from
    [multiscale_min, multiscale_max]; a batch is made of mosaics of 4
    dataset images (numpy, from the trainer's ``default_rng(seed)``)."""

    def __init__(self, cfg: YoloV3Config, img_dir: str, seed: int = 0,
                 device="cuda"):
        import os

        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.files = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if not self.files:
            raise ValueError(f"no images in {img_dir}")
        self.init_fn, self.step = make_v3_train_step(cfg, device=device)
        self.state = self.init_fn(torch.Generator().manual_seed(seed))
        self.scales_used = []

    def _load(self, path):
        import cv2

        from yoloface_tpu_torch.train.data import load_labels_for

        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        labels = load_labels_for(path)
        # [cx,cy,w,h,cls] -> [cls,cx,cy,w,h] (mosaic convention)
        return img, labels[:, [4, 0, 1, 2, 3]]

    def _make_batch(self, img_size: int, batch: int):
        import cv2

        imgs, tgts = [], []
        cfg = YoloV3Config(**{**self.cfg.__dict__, "img_size": img_size})
        for _ in range(batch):
            if self.cfg.mosaic:
                quad = [self._load(self.files[int(
                    self.rng.integers(0, len(self.files)))])
                    for _ in range(4)]
                mosaic, lab = mosaic_augmentation(
                    [q[0] for q in quad], [q[1] for q in quad],
                    img_size, self.rng)
            else:
                mosaic, lab = self._load(self.files[int(
                    self.rng.integers(0, len(self.files)))])
                mosaic = cv2.resize(mosaic, (img_size, img_size))
            if self.cfg.rotate and self.rng.random() < self.cfg.rotate_prob:
                mosaic, lab = random_rotate(mosaic, lab, self.rng)
            if self.cfg.crop and self.rng.random() < self.cfg.crop_prob:
                mosaic, lab = random_crop(mosaic, lab, self.rng)
                mosaic = cv2.resize(mosaic, (img_size, img_size))
            imgs.append(mosaic.astype(np.float32) / 255.0)
            tgts.append(build_v3_target(lab, cfg))
        return np.stack(imgs), np.stack(tgts)

    def fit(self, epochs: int, steps_per_epoch: Optional[int] = None,
            batch: Optional[int] = None):
        batch = batch or self.cfg.batch_size
        steps_per_epoch = steps_per_epoch or self.cfg.steps_per_epoch
        history = []
        for epoch in range(epochs):
            size = self.cfg.sample_scale(self.rng)
            self.scales_used.append(size)
            losses = []
            for _ in range(steps_per_epoch):
                imgs, tgts = self._make_batch(size, batch)
                self.state, m = self.step(self.state, imgs, tgts)
                losses.append(float(m["loss"]))
            history.append(float(np.mean(losses)))
            print(f"v3 epoch {epoch + 1}/{epochs} size={size} "
                  f"loss={history[-1]:.3f}")
        return history
