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
    (``surface_frames_sha256``), and from the JAX ``fast2`` engine
    (``surface_fast20``, ``surface_fast21``);
  * the .tflite test graphs (``TFLITE_GRAPHS``): the fuzz graphs of
    tests/test_tiled_fuzz.py (seeds 0-7) and the v3-tiny FPN of
    tests/test_darknet_ptq.py, written as int8 .tflite under tests/data/ by
    the JAX package's exporter; the JAX ``fast2``, ``fast`` and ``exact``
    outputs of each as the JAX importer reads it back, on
    ``tflite_frames(name)`` (``tflite_<name>_<bits><k>``), and the frames'
    sha256 (``tflite_<name>_frames_sha256``).
chip_smoke.py holds the card's output against it without jax;
tests/test_torch_pipeline.py, tests/test_torch_tiled.py,
tests/test_torch_fused.py, tests/test_torch_perop.py and
tests/test_torch_arena.py recompute the JAX side and hold it against the
file.  ``GraphMaker``, which builds the op-surface graph, also builds the
one-op graphs of tests/test_torch_perop.py and the published yolov3-tiny
(``yolov3_tiny_graph``).

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
SEED_V3TINY = 416
SEED_TFLITE = 60
TFLITE_GRAPHS = tuple(f"fuzz{s}" for s in range(8)) + ("v3tiny_fpn",)
TFLITE_INPUTS = {**{f"fuzz{s}": (3, 14) for s in range(8)},
                 "v3tiny_fpn": (2, 32)}
KEYS_SURFACE_FAST2 = ("surface_fast20", "surface_fast21")


def tflite_key(name: str, bits: str, k: int) -> str:
    """The golden key of output ``k`` of a .tflite test graph."""
    return f"tflite_{name}_{bits}{k}"


KEYS_TFLITE = tuple(
    key for name in TFLITE_GRAPHS
    for key in (f"tflite_{name}_frames_sha256",
                *(tflite_key(name, bits, k) for bits in ("fast2", "fast",
                                                         "exact")
                  for k in range(2 if name == "v3tiny_fpn" else 1))))


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


def yolov3_tiny_graph(size: int = 416, div: int = 1, seed: int = SEED_V3TINY):
    """The published yolov3-tiny (darknet's ``yolov3-tiny.cfg``, layers
    0-23) as an int8 graph in the port's IR, weights from numpy seed
    ``seed`` (numpy only: the card's machine builds the same graph).

    int8 [N,size,size,3] in; 13 convs (3x3 SAME, or 1x1), each but the two
    255-channel heads followed by a LEAKY_RELU (alpha 0.1); 6 max-pools,
    the sixth 2x2 stride 1 SAME; the route of layer 13, a 1x1 conv, a x2
    RESIZE and the concat with layer 8.  Outputs: the two heads,
    [N,size/32,size/32,255] and [N,size/16,size/16,255].  ``div`` divides
    every channel count (rounded up) for a small test graph; ``size`` must
    be a multiple of 32.

    Scales: a conv's output scale is its input scale times sqrt(K) * 0.52,
    so that an int8 input spread of about 50 and the weights' spread of
    about 52 (GraphMaker draws them from -90..90 at scales 0.004-0.012)
    give outputs of about 40 codes.  The effective requant multiplier then
    stays below 0.005, its shift is negative, and
    ``specs.check_exact_domain`` holds for every conv at full width: at
    K = 4,608 (layer 12) the largest |acc| bound is 128 * 4,608 * 90 plus
    the zero-point fold, about 2**26.7."""
    b = GraphMaker(seed)

    def ch(c):
        return -(-c // div)

    def conv(x, co, k, leaky=True, out_q=None):
        _, hw, _, ci = b.tensors[x].shape
        s_c = b.tensors[x].qparams.scale * np.sqrt(k * k * ci) * 0.52
        y = b.conv(x, co, (k, k), 1, "SAME",
                   b.act(hw, co, s_c, int(b.rng.integers(-8, 9))))
        if not leaky:
            return y
        s, zp = out_q or (s_c * 0.75, -90)
        return b.op("LEAKY_RELU", [y], b.act(hw, co, s, zp), alpha=0.1)

    def pool(x, stride):
        _, hw, _, c = b.tensors[x].shape
        q = b.tensors[x].qparams
        return b.op("MAX_POOL_2D", [x],
                    b.act(-(-hw // stride), c, q.scale, q.zero_point),
                    padding="SAME", stride_h=stride, stride_w=stride,
                    filter_h=2, filter_w=2, activation="NONE")

    x = b.act(size, 3, 1.0 / 255.0, -128)
    y = x
    for k, co in enumerate((16, 32, 64, 128, 256, 512)):       # layers 0-11
        y = conv(y, ch(co), 3)
        if co == 256:
            route8 = y
        y = pool(y, 2 if co < 512 else 1)
    y = conv(y, ch(1024), 3)                                     # 12
    route13 = conv(y, ch(256), 1)                                # 13
    head0 = conv(conv(route13, ch(512), 3), ch(255), 1, leaky=False)
    q8 = b.tensors[route8].qparams
    y = conv(route13, ch(128), 1, out_q=(q8.scale, q8.zero_point))  # 18
    _, hw, _, c = b.tensors[y].shape
    size_t = b.tensor((2,), np.int32,
                      data=np.asarray([2 * hw, 2 * hw], np.int32))
    up = b.op("RESIZE_NEAREST_NEIGHBOR", [y, size_t],              # 19
              b.act(2 * hw, c, q8.scale, q8.zero_point),
              align_corners=False, half_pixel_centers=False)
    cat = b.op("CONCATENATION", [up, route8],                       # 20
               b.act(2 * hw, c + b.tensors[route8].shape[3], q8.scale,
                     q8.zero_point), axis=3, activation="NONE")
    head1 = conv(conv(cat, ch(256), 3), ch(255), 1, leaky=False)  # 21-22
    return b.graph([x], [head0, head1], f"yolov3_tiny_{size}")


def yolov3_tiny_frames(n: int, size: int = 416) -> np.ndarray:
    """int8 [n,size,size,3] inputs of ``yolov3_tiny_graph`` (numpy only)."""
    rng = np.random.default_rng(SEED_V3TINY + 1)
    return rng.integers(-128, 128, (n, size, size, 3), dtype=np.int64
                        ).astype(np.int8)


# --------------------------------------------------------------------------
# the .tflite test graphs: the JAX package's fuzz graphs and v3-tiny FPN
# --------------------------------------------------------------------------
def tflite_path(name: str) -> str:
    return os.path.join(REPO, "tests", "data", f"{name}_int8.tflite")


def tflite_frames(name: str) -> np.ndarray:
    """int8 inputs of a .tflite test graph (numpy only): 3 frames of
    14x14x3 for ``fuzz<seed>``, 2 of 32x32x3 for ``v3tiny_fpn``."""
    n, hw = TFLITE_INPUTS[name]
    rng = np.random.default_rng(SEED_TFLITE + TFLITE_GRAPHS.index(name))
    return rng.integers(-128, 128, (n, hw, hw, 3), dtype=np.int64
                        ).astype(np.int8)


def write_tflite_graphs() -> None:
    """The fuzz graphs of tests/test_tiled_fuzz.py (seeds 0-7) and the
    two-headed v3-tiny FPN of tests/test_darknet_ptq.py (32x32, calibrated
    as tests/test_torch_fused.py does) as int8 .tflite under tests/data/,
    through the JAX package's exporter."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_darknet_ptq as ptq
    from test_tiled_fuzz import _int8_graph
    from yoloface_tpu.io.darknet_cfg import DarknetNet, template_from_darknet
    from yoloface_tpu.io.tflite_export import save_tflite
    from yoloface_tpu.quantize.calibrate import calibrate_from_weights
    for name in TFLITE_GRAPHS:
        if name.startswith("fuzz"):
            g, _ = _int8_graph(int(name[4:]))
        else:
            net = DarknetNet(ptq.V3_TINY_CFG)
            template, weights = template_from_darknet(
                net, ptq._random_params(net))
            rep = np.random.default_rng(5).uniform(0, 1, (16, 32, 32, 3))
            g = calibrate_from_weights(weights, rep.astype(np.float32),
                                       template)
        save_tflite(g, tflite_path(name))


def jax_outputs_tflite() -> dict:
    """The JAX fast2, fast and exact outputs of each .tflite test graph (as
    the JAX importer reads it back) on ``tflite_frames``, and the frames'
    sha256."""
    from yoloface_tpu.io.tflite_import import load_tflite
    from yoloface_tpu.runtime.engine import Int8Engine
    out = {}
    for name in TFLITE_GRAPHS:
        g = load_tflite(tflite_path(name))
        x = tflite_frames(name)
        out[f"tflite_{name}_frames_sha256"] = np.array(sha256(x))
        for bits in ("fast2", "fast", "exact"):
            ys = Int8Engine(g, bits)(x)
            for k, y in enumerate(ys if isinstance(ys, tuple) else (ys,)):
                out[tflite_key(name, bits, k)] = np.asarray(y)
    return out


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


def jax_outputs_surface_fast2() -> dict:
    """The op-surface graph's outputs from the JAX ``fast2`` engine on
    ``surface_frames()``: what ``arena2`` and ``tiled2`` give."""
    from yoloface_tpu.runtime.engine import Int8Engine
    ys = Int8Engine(jax_graph(surface_graph()), "fast2")(surface_frames())
    return {f"surface_fast2{k}": np.asarray(y) for k, y in enumerate(ys)}


def main() -> int:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    frames = golden_frames()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    write_tflite_graphs()
    np.savez_compressed(OUT, frames=frames, **jax_outputs(frames),
                        **jax_outputs_448(), **jax_outputs_surface(),
                        **jax_outputs_surface_fast2(), **jax_outputs_tflite())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
