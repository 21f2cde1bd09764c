"""End-to-end learning demo: train yoloface on synthetic targets, calibrate
it to int8, serve it through the arena kernels and measure detection
quality.

The counterpart of ``examples/train_synthetic.py``: the whole loop of the
reference (train.py -> tflite_quantize.py -> the MCU runtime) as one
script, on the card unless ``--device cpu``:
  1. synthesize a detection task (a bright square on a textured
     background);
  2. train the float model (``train/steps.py``);
  3. PTQ-calibrate to int8 on the topology of
     ``checkpoints/yoloface_corpus_int8.tflite`` and run the graph through
     ``FacePipeline(Int8Engine(graph, "arena_exact"))``;
  4. report the IoU and hit rate of the deployed int8 detector.

Run: python -m yoloface_tpu_torch.examples.train_synthetic [--steps 400]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")


def make_sample(rng: np.random.Generator):
    """One 56x56 image: textured background + one bright square; returns
    (image f32 [56,56,3], normalized label [cx, cy, w, h, cls])."""
    img = rng.uniform(0.0, 0.35, (56, 56, 3)).astype(np.float32)
    size = int(rng.integers(14, 28))
    x0 = int(rng.integers(0, 56 - size))
    y0 = int(rng.integers(0, 56 - size))
    color = rng.uniform(0.75, 1.0, 3).astype(np.float32)
    img[y0:y0 + size, x0:x0 + size] = color
    cx = (x0 + size / 2) / 56.0
    cy = (y0 + size / 2) / 56.0
    return img, np.array([[cx, cy, size / 56.0, size / 56.0, 0.0]])


def make_batch(rng, n):
    """(images [n,56,56,3] f32, targets [n,3,7,7,6], labels [n,5])."""
    from yoloface_tpu_torch.train.data import build_target
    imgs, tgts, labels = [], [], []
    for _ in range(n):
        img, lab = make_sample(rng)
        imgs.append(img)
        tgts.append(build_target(lab))
        labels.append(lab[0])
    return (np.stack(imgs), np.stack(tgts), np.stack(labels))


def train(steps: int = 400, batch: int = 32, lr: float = 3e-3,
          seed: int = 0, device="cuda", log_every: int = 0):
    """Adam with the cosine schedule on fresh synthetic batches; the
    weights start from a ``torch.Generator`` seeded with ``seed``, the
    batches from ``numpy.random.default_rng(seed)``.  Prints the loss every
    ``log_every`` steps (0: every steps // 8).  -> the train state."""
    import torch

    from yoloface_tpu_torch.train.steps import (TrainConfig, init_state,
                                                make_train_step)
    cfg = TrainConfig(learning_rate=lr, epochs=1, steps_per_epoch=steps,
                      batch_size=batch)
    state = init_state(torch.Generator().manual_seed(seed), cfg,
                       device=device)
    step = make_train_step(cfg)
    rng = np.random.default_rng(seed)
    every = log_every or max(steps // 8, 1)
    for i in range(steps):
        imgs, tgts, _ = make_batch(rng, batch)
        state, metrics = step(state, imgs, tgts)
        if (i + 1) % every == 0:
            print(f"step {i + 1}/{steps}  loss={float(metrics['loss']):.3f}")
    return state


def calibration_sets(seed: int = 123, n_eval: int = 24):
    """(16 representative images, n_eval evaluation images, their labels)
    from one ``default_rng(seed)``, in JAX's order."""
    rng = np.random.default_rng(seed)
    rep_imgs, _, _ = make_batch(rng, 16)
    imgs, _, labels = make_batch(rng, n_eval)
    return rep_imgs, imgs, labels


def score(det, labels):
    """The best detection of each image against its square: hit rate
    (IoU >= 0.5), mean IoU of the images with a detection, their count."""
    from yoloface_tpu_torch.train.evaluate import box_iou
    n_eval = len(labels)
    hits, ious = 0, []
    for i in range(n_eval):
        gt = labels[i]
        gt_box = np.array([[(gt[0] - gt[2] / 2) * 56,
                            (gt[1] - gt[3] / 2) * 56,
                            (gt[0] + gt[2] / 2) * 56,
                            (gt[1] + gt[3] / 2) * 56]])
        v = det["valid"][i]
        if not v.any():
            continue
        best = det["boxes"][i][v][np.argmax(det["scores"][i][v])]
        iou = float(box_iou(best[None], gt_box)[0, 0])
        ious.append(iou)
        if iou >= 0.5:
            hits += 1
    return {"hit_rate": hits / n_eval,
            "mean_iou": float(np.mean(ious)) if ious else 0.0,
            "detected": len(ious), "n_eval": n_eval}


def int8_inputs(imgs) -> np.ndarray:
    """float images in [0,1] -> the int8 network input (x * 255 - 128)."""
    return np.clip(np.round(imgs * 255) - 128, -128, 127).astype(np.int8)


def evaluate_deployed(state, n_eval: int = 24, conf: float = 0.5,
                      seed: int = 123, mode: str = "arena_exact",
                      graph=None):
    """Calibrate the trained model (on its device) and measure the int8
    detector in ``mode`` there; ``graph``, if given, is served instead."""
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline
    from yoloface_tpu_torch.pipeline.head import HeadConfig
    from yoloface_tpu_torch.quantize.calibrate import calibrate
    from yoloface_tpu_torch.runtime.engine import Int8Engine

    model = state["model"]
    device = next(model.parameters()).device
    rep_imgs, imgs, labels = calibration_sets(seed, n_eval)
    if graph is None:
        graph = calibrate(model, rep_imgs, load_tflite(CORPUS),
                          device=device)
    pipe = FacePipeline(Int8Engine(graph, mode, device),
                        HeadConfig(conf_threshold=conf))
    return score(pipe.detect_int8(int8_inputs(imgs)), labels)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    state = train(args.steps, args.batch, args.lr, device=args.device)
    metrics = evaluate_deployed(state)
    print("deployed int8 detector:", metrics)
    return metrics


if __name__ == "__main__":
    main()
