"""Detection CLI: ``python -m yoloface_tpu_torch.detect --image face.jpg``.

The counterpart of ``yoloface_tpu.detect``, with its flags (``--image``,
``--batch-dir``, ``--video``, ``--save-vis``, ``--report``, ``--conf``,
``--iou``, ``--retarget``) and its report.  ``--mode`` takes the port's
engine modes and the JAX package's names (``JAX_MODES``); the default,
``arena_exact``, gives the JAX default's ``exact`` bits on the kernels.
``--device`` defaults to the card (``cpu`` runs every kernel's plain
version); ``--tflite`` to the repository's corpus checkpoint.

Decoding images (cv2) is kept apart from the run on int8 arrays:
``detect_arrays`` and ``summarize`` take int8 [N,S,S,3] network inputs
and need no cv2, so the card's machine can drive them without it; the
image modes raise an ImportError naming cv2 where it is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yoloface_tpu_torch.runtime.engine import MODES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_TFLITE = os.path.join(REPO, "checkpoints",
                              "yoloface_corpus_int8.tflite")
DEFAULT_MODE = "arena_exact"
# the JAX package's engine modes -> the port's of the same bits; exact,
# fast and fast2 keep their names (the port's plain modes)
JAX_MODES = {"pallas_mxu2": "arena2", "pallas_mxu": "arena",
             "pallas_arena": "arena", "pallas_mxu_exact": "arena_exact",
             "pallas_arena_exact": "arena_exact", "pallas_fused": "fused",
             "pallas_fused_exact": "fused_exact", "pallas": "perop",
             "pallas_exact": "perop_exact", "pallas_tiled": "tiled",
             "pallas_tiled2": "tiled2", "pallas_tiled_exact": "tiled_exact"}


def port_mode(mode: str) -> str:
    """A port mode, or a JAX mode name, -> the port's mode."""
    return JAX_MODES.get(mode, mode)


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the image, batch-dir and video modes read images "
                          "with OpenCV (cv2), which is not installed") from e
    return cv2


def to_input(rgb: np.ndarray, size: int = 56) -> np.ndarray:
    """A uint8 RGB image -> int8 [size,size,3] network input
    (tflite_prediction.py:34-37: resize, then x - 128)."""
    x = _cv2().resize(rgb, (size, size)).astype(np.float32)
    return (x - 128.0).astype(np.int8)


def preprocess_image(path: str, size: int = 56):
    cv2 = _cv2()
    img = cv2.imread(path)
    if img is None:
        raise SystemExit(f"cannot read image: {path}")
    h, w = img.shape[:2]
    x = to_input(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), size)
    return img, x, (w / size, h / size)


def detections_to_records(det, i, scales=(1.0, 1.0)):
    wx, hy = scales
    out = []
    for box, score, ok in zip(det["boxes"][i], det["scores"][i],
                              det["valid"][i]):
        if not ok:
            continue
        x1, y1, x2, y2 = box
        out.append({
            "box_net": [float(v) for v in box],
            "box_image": [float(x1 * wx), float(y1 * hy),
                          float(x2 * wx), float(y2 * hy)],
            "confidence": float(score),
        })
    return out


def load(tflite: str, mode: str = DEFAULT_MODE, device="cuda",
         retarget: int = 1, conf: float = 0.7, iou: float = 0.5):
    """The CLI's pipeline: ``tflite`` (retargeted to 56 * ``retarget`` px
    where ``retarget`` > 1) in ``mode`` (a port or JAX name) on
    ``device``."""
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline
    from yoloface_tpu_torch.pipeline.head import HeadConfig
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    graph = load_tflite(tflite)
    if retarget > 1:
        from yoloface_tpu_torch.graph.retarget import retarget_spatial
        graph = retarget_spatial(graph, retarget)
    return FacePipeline(
        Int8Engine(graph, port_mode(mode), device),
        HeadConfig(grid=7 * retarget, conf_threshold=conf,
                   iou_threshold=iou))


def detect_arrays(pipe, xs: np.ndarray, names: Sequence[str],
                  scales: Optional[Sequence[Tuple[float, float]]] = None
                  ) -> Dict[str, List[dict]]:
    """int8 network inputs [N,S,S,3], one name each -> the report's
    records by name, boxes scaled to the image by ``scales``."""
    det = pipe.detect_int8(xs)
    return {name: detections_to_records(
        det, i, scales[i] if scales is not None else (1.0, 1.0))
        for i, name in enumerate(names)}


def summarize(results: Dict[str, List[dict]],
              report: Optional[str] = None, out=None) -> dict:
    """The report (written to ``report`` where given) and its text (on
    ``out``, standard output by default)."""
    out = out or sys.stdout
    n_total = sum(len(v) for v in results.values())
    summary = {"inputs": len(results), "faces": n_total,
               "detections": results}
    if report:
        with open(report, "w") as f:
            json.dump(summary, f, indent=2)
    for name, recs in results.items():
        print(f"{name}: {len(recs)} face(s)", file=out)
        for r in recs:
            b = ", ".join(f"{v:.1f}" for v in r["box_image"])
            print(f"  [{b}]  conf={r['confidence']:.2f}", file=out)
    print(f"total: {n_total} face(s) in {len(results)} input(s)", file=out)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="yoloface detector")
    p.add_argument("--tflite", default=DEFAULT_TFLITE)
    p.add_argument("--mode", default=DEFAULT_MODE,
                   choices=list(MODES) + list(JAX_MODES),
                   help="a port engine mode or the JAX package's name of "
                        "one (pallas_mxu2 = arena2, ...)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--retarget", type=int, default=1, metavar="K",
                   help="run the spatially retargeted graph at 56*K px "
                        "(graph/retarget.py): detects yoloface-scale "
                        "faces on a K-times larger frame at full "
                        "resolution (grid 7*K, same stride/anchors)")
    p.add_argument("--conf", type=float, default=0.7)
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--image", help="single image path")
    p.add_argument("--batch-dir", help="directory of images")
    p.add_argument("--video", help="video file (frame-by-frame)")
    p.add_argument("--save-vis", help="write annotated image(s) here")
    p.add_argument("--report", help="write a JSON report here")
    args = p.parse_args(argv)
    if not (args.image or args.batch_dir or args.video):
        p.error("one of --image / --batch-dir / --video is required")

    pipe = load(args.tflite, args.mode, args.device, args.retarget,
                args.conf, args.iou)
    size = 56 * args.retarget
    results = {}
    if args.image:
        img, x, scales = preprocess_image(args.image, size)
        name = os.path.basename(args.image)
        results = detect_arrays(pipe, x[None], [name], [scales])
        _maybe_draw(img, results[name], args.save_vis, args.image)
    elif args.batch_dir:
        files = sorted(f for f in os.listdir(args.batch_dir)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        imgs, xs, scales_l = [], [], []
        for f in files:
            img, x, scales = preprocess_image(
                os.path.join(args.batch_dir, f), size)
            imgs.append(img)
            xs.append(x)
            scales_l.append(scales)
        results = detect_arrays(pipe, np.stack(xs), files, scales_l)
        if args.save_vis:
            for img, f in zip(imgs, files):
                _maybe_draw(img, results[f], args.save_vis, f)
    else:
        cv2 = _cv2()
        cap = cv2.VideoCapture(args.video)
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            x = to_input(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), size)
            results.update(detect_arrays(pipe, x[None], [f"frame_{idx}"]))
            idx += 1
        cap.release()

    summarize(results, args.report)
    return 0


def _maybe_draw(img, recs, save_dir, name):
    if not save_dir:
        return
    cv2 = _cv2()
    os.makedirs(save_dir, exist_ok=True)
    for r in recs:
        x1, y1, x2, y2 = (int(v) for v in r["box_image"])
        cv2.rectangle(img, (x1, y1), (x2, y2), (0, 0, 255), 2)
    cv2.imwrite(os.path.join(save_dir, os.path.basename(name)), img)


if __name__ == "__main__":
    sys.exit(main())
