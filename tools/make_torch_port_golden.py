"""Write tests/data/torch_port_frames.npz, the golden file of the PyTorch port.

It holds 8 RGB565 frames, made from 8 images of checkpoints/vis/ (cv2
read, BGR->RGB, resize to 112x112, 5/6/5 truncation), with what the JAX
pipelines give for them:
  * ``fast2`` engine: the int8 head tensor ``head`` [8,7,7,18] and the
    staged head's detections ranked by a stable sort (``boxes``,
    ``scores``, ``valid``, ``count``);
  * ``exact`` engine: ``head_exact`` and the staged head's detections
    ranked by the top-K Pallas kernel in interpret mode (``exact_boxes``,
    ``exact_scores``, ``exact_valid``, ``exact_count``);
  * the 448 family (``retarget_spatial(corpus, 8)``): the int8 net output
    [2,56,56,18] of the JAX ``fast2`` and ``exact`` engines (``head448``,
    ``head448_exact``) for two int8 448x448x3 frames made by
    ``frames448()`` from numpy seed ``SEED448``.  The frames themselves are
    not stored (602,112 B each), only their sha256 (``frames448_sha256``).
chip_smoke.py holds the card's output against it without jax;
tests/test_torch_pipeline.py and tests/test_torch_tiled.py recompute the
JAX side and hold it against the file.

Run from the repository root, on the CPU:
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
# seven images on which the corpus model finds 1 or 2 faces at 112x112
# RGB565, and one (img_1122) on which it finds none
IMAGES = ("img_1087", "img_1122", "img_331", "img_457", "img_558", "img_82",
          "img_935", "img_967")
SEED448 = 448
KEYS448 = ("head448", "head448_exact", "frames448_sha256")


def golden_frames() -> np.ndarray:
    """uint16 RGB565 [8,112,112] from the IMAGES of checkpoints/vis."""
    import cv2

    from yoloface_tpu.pipeline.preprocess import encode_rgb565
    rgbs = []
    for name in IMAGES:
        path = os.path.join(REPO, "checkpoints", "vis", name + ".jpg")
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        rgbs.append(cv2.resize(img, (112, 112)))
    return encode_rgb565(np.stack(rgbs))


def jax_outputs(frames: np.ndarray) -> dict:
    """The golden arrays of the JAX fast2 and exact pipelines."""
    from yoloface_tpu.io.tflite_import import load_tflite
    from yoloface_tpu.pipeline import preprocess
    from yoloface_tpu.pipeline.e2e import FacePipeline
    from yoloface_tpu.pipeline.head import HeadConfig
    from yoloface_tpu.runtime.engine import Int8Engine
    graph = load_tflite(CORPUS)
    x = np.asarray(preprocess.rgb565_to_int8_input(frames))
    out = {}
    for mode, prefix, topk in (("fast2", "", False), ("exact", "exact_", True)):
        eng = Int8Engine(graph, mode)
        pipe = FacePipeline(eng, HeadConfig(use_fused_head=False,
                                            use_pallas_topk=topk))
        out["head" + ("_exact" if prefix else "")] = np.asarray(eng(x))
        out.update({prefix + k: np.asarray(v)
                    for k, v in pipe.detect_rgb565(frames).items()})
    return out


def frames448() -> np.ndarray:
    """int8 [2,448,448,3] from numpy seed SEED448 (numpy only: the card's
    machine makes the same frames)."""
    rng = np.random.default_rng(SEED448)
    x = rng.integers(-128, 128, (2, 448, 448, 3), dtype=np.int64)
    return x.astype(np.int8)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def jax_outputs_448() -> dict:
    """The golden 448 arrays: JAX fast2 and exact on ``frames448()``."""
    from yoloface_tpu.graph.retarget import retarget_spatial
    from yoloface_tpu.io.tflite_import import load_tflite
    from yoloface_tpu.runtime.engine import Int8Engine
    graph = retarget_spatial(load_tflite(CORPUS), 8)
    x = frames448()
    return {"head448": np.asarray(Int8Engine(graph, "fast2")(x)),
            "head448_exact": np.asarray(Int8Engine(graph, "exact")(x)),
            "frames448_sha256": np.array(sha256(x))}


def main() -> int:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    frames = golden_frames()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, frames=frames, **jax_outputs(frames),
                        **jax_outputs_448())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
