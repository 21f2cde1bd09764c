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
  * ``pallas_fused`` engine (interpret mode): ``head_fast``;
  * the 448 family (``retarget_spatial(corpus, 8)``): the int8 net output
    [2,56,56,18] of the JAX ``fast2`` and ``exact`` engines (``head448``,
    ``head448_exact``) for two int8 448x448x3 frames made by
    ``frames448()`` from numpy seed ``SEED448``.  The frames themselves are
    not stored (602,112 B each), only their sha256 (``frames448_sha256``);
  * the op-surface graph of the fused family (``surface_graph()``, built
    with the port's IR from numpy seed ``SEED_SURFACE``): its two outputs
    from JAX ``pallas_fused`` and ``pallas_fused_exact`` (interpret mode) on
    ``surface_frames()`` (``surface_fast0``, ``surface_fast1``,
    ``surface_exact0``, ``surface_exact1``) and the frames' sha256
    (``surface_frames_sha256``).
chip_smoke.py holds the card's output against it without jax;
tests/test_torch_pipeline.py, tests/test_torch_tiled.py,
tests/test_torch_fused.py and tests/test_torch_perop.py recompute the JAX
side and hold it against the file.  ``GraphMaker``, which builds the
op-surface graph, also builds the one-op graphs of
tests/test_torch_perop.py.

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
SEED_SURFACE = 7
KEYS_SURFACE = ("surface_fast0", "surface_fast1", "surface_exact0",
                "surface_exact1", "surface_frames_sha256")


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
    out["head_fast"] = np.asarray(Int8Engine(graph, "pallas_fused")(x))
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


class GraphMaker:
    """An int8 graph in the port's IR, op by op, with weights, biases and
    scales drawn from numpy seed ``seed`` (numpy only)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.tensors, self.ops = [], []

    def tensor(self, shape, dtype=np.int8, scale=None, zp=0, data=None,
               dim=0) -> int:
        from yoloface_tpu_torch.graph.ir import QParams, TensorDef
        q = None
        if scale is not None:
            scales = tuple(float(s) for s in np.atleast_1d(scale))
            q = QParams(scales, (int(zp),) * len(scales), dim)
        self.tensors.append(TensorDef(len(self.tensors),
                                      f"t{len(self.tensors)}", tuple(shape),
                                      np.dtype(dtype), q, data))
        return len(self.tensors) - 1

    def act(self, hw, c, scale, zp) -> int:
        return self.tensor((1, hw, hw, c), scale=scale, zp=zp)

    def op(self, name, ins, out, **attrs) -> int:
        from yoloface_tpu_torch.graph.ir import OpDef
        self.ops.append(OpDef(len(self.ops), name, list(ins), [out], attrs))
        return out

    def conv(self, x, co, kernel, stride, padding, out, depthwise=False):
        """A CONV_2D (or DEPTHWISE_CONV_2D) with a ``kernel`` (kh, kw)."""
        ci = self.tensors[x].shape[3]
        shape = (1, *kernel, ci) if depthwise else (co, *kernel, ci)
        s_w = self.rng.uniform(0.004, 0.012, co)
        w = self.tensor(shape, scale=s_w, dim=3 if depthwise else 0,
                        data=self.rng.integers(-90, 91, shape).astype(np.int8))
        s_b = self.tensors[x].qparams.scale * s_w
        b = self.tensor((co,), np.int32, scale=s_b,
                        data=self.rng.integers(-3000, 3001, co)
                        .astype(np.int32))
        return self.op("DEPTHWISE_CONV_2D" if depthwise else "CONV_2D",
                       [x, w, b], out, padding=padding, stride_h=stride,
                       stride_w=stride, activation="NONE",
                       **({"depth_multiplier": 1} if depthwise else {}))

    def pad(self, x, rows, out):
        p = self.tensor((4, 2), np.int32, data=np.asarray(rows, np.int32))
        return self.op("PAD", [x, p], out)

    def graph(self, inputs, outputs, name: str = ""):
        from yoloface_tpu_torch.graph.ir import GraphDef
        return GraphDef(self.tensors, self.ops, list(inputs), list(outputs),
                        name)


def surface_graph():
    """The op-surface graph of the fused family, in the port's IR (numpy
    only: the card's machine builds the same graph).  int8 [N,15,15,3] in;
    a PAD absorbed by a 3x3 stride-2 conv whose LEAKY fuses; a depthwise
    3x3 stride 2; a 1x1 conv read by a standalone LEAKY and a RELU; RELU6,
    QUANTIZE, ADD, a x2 RESIZE, a LOGISTIC, a 3-input concat; a standalone
    PAD into a VALID 3x3 max-pool (output 0, [N,4,4,24]) and a SAME 3x3
    max-pool on its odd width (output 1, [N,5,5,24])."""
    b = GraphMaker(SEED_SURFACE)
    act, op = b.act, b.op
    x = act(15, 3, 0.05, -3)
    p0 = b.pad(x, [[0, 0], [1, 1], [1, 1], [0, 0]], act(17, 3, 0.05, -3))
    c0 = b.conv(p0, 8, (3, 3), 2, "VALID", act(8, 8, 0.09, 6))
    l0 = op("LEAKY_RELU", [c0], act(8, 8, 0.07, -20), alpha=0.1)
    d0 = b.conv(l0, 8, (3, 3), 2, "SAME", act(4, 8, 0.06, 2), depthwise=True)
    c1 = b.conv(d0, 8, (1, 1), 1, "SAME", act(4, 8, 0.08, -5))
    l1 = op("LEAKY_RELU", [c1], act(4, 8, 0.05, 9), alpha=0.1)
    r0 = op("RELU", [c1], act(4, 8, 0.08, -5))
    r6 = op("RELU6", [l1], act(4, 8, 0.05, 9))
    q0 = op("QUANTIZE", [r0], act(4, 8, 0.11, -30))
    a0 = op("ADD", [r6, q0], act(4, 8, 0.09, 4))
    size = b.tensor((2,), np.int32, data=np.asarray([8, 8], np.int32))
    z0 = op("RESIZE_NEAREST_NEIGHBOR", [a0, size], act(8, 8, 0.09, 4),
            align_corners=False, half_pixel_centers=False)
    s0 = op("LOGISTIC", [l0], act(8, 8, 1.0 / 256.0, -128))
    cat = op("CONCATENATION", [z0, l0, s0], act(8, 24, 0.09, 4), axis=3,
             activation="NONE")
    p1 = b.pad(cat, [[0, 0], [0, 1], [1, 0], [0, 0]], act(9, 24, 0.09, 4))
    m0 = op("MAX_POOL_2D", [p1], act(4, 24, 0.09, 4), padding="VALID",
            stride_h=2, stride_w=2, filter_h=3, filter_w=3,
            activation="NONE")
    m1 = op("MAX_POOL_2D", [p1], act(5, 24, 0.09, 4), padding="SAME",
            stride_h=2, stride_w=2, filter_h=3, filter_w=3,
            activation="NONE")
    return b.graph([x], [m0, m1], "op_surface")


def surface_frames(n: int = 3) -> np.ndarray:
    """int8 [n,15,15,3] inputs of the op-surface graph (numpy only)."""
    rng = np.random.default_rng(SEED_SURFACE + 1)
    return rng.integers(-128, 128, (n, 15, 15, 3), dtype=np.int64
                        ).astype(np.int8)


def jax_graph(g):
    """The port's GraphDef -> the JAX package's, field by field."""
    from yoloface_tpu.graph import ir
    return ir.GraphDef(
        [ir.TensorDef(t.index, t.name, t.shape, t.dtype,
                      None if t.qparams is None else ir.QParams(
                          t.qparams.scales, t.qparams.zero_points,
                          t.qparams.quantized_dimension), t.data)
         for t in g.tensors],
        [ir.OpDef(o.index, o.opname, list(o.inputs), list(o.outputs),
                  dict(o.attrs)) for o in g.ops],
        list(g.inputs), list(g.outputs), g.name)


def jax_outputs_surface() -> dict:
    """The op-surface graph's outputs from JAX ``pallas_fused`` and
    ``pallas_fused_exact`` on ``surface_frames()``."""
    from yoloface_tpu.runtime.engine import Int8Engine
    g = jax_graph(surface_graph())
    x = surface_frames()
    out = {"surface_frames_sha256": np.array(sha256(x))}
    for bits, mode in (("fast", "pallas_fused"),
                       ("exact", "pallas_fused_exact")):
        for k, y in enumerate(Int8Engine(g, mode)(x)):
            out[f"surface_{bits}{k}"] = np.asarray(y)
    return out


def main() -> int:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    frames = golden_frames()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, frames=frames, **jax_outputs(frames),
                        **jax_outputs_448(), **jax_outputs_surface())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
