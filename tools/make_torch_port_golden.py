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
    sha256 (``tflite_<name>_frames_sha256``);
  * the v3-tiny FPN's detections: JAX ``detect_multihead`` on the heads of
    its JAX ``fast2``, ``fast`` and ``exact`` engines for
    ``tflite_frames("v3tiny_fpn")``, with the head configurations and
    arguments of tests/test_darknet_ptq.py (``FPN_HEADS``,
    ``FPN_DETECT``): ``multihead_v3tiny_fpn_<bits>_<boxes|scores|valid>``.
  * the JAX package's firmware-protocol text of the 8 golden frames from
    its ``CameraStreamer`` around the ``fast2`` and ``exact`` pipelines
    above (``protocol_fast2``, ``protocol_exact``);
  * the interchange formats: ``tests/data/yoloface_converted_int8.tflite``,
    the corpus weights (``variables_from_template``) through the port's
    TensorFlow chain (``quantize/tf_convert.checkpoint_to_int8_tflite``,
    Keras h5, frozen pb, the TFLite converter) with a representative set of
    ``CONVERTED_REP`` images from numpy seed ``SEED_CONVERTED``; the JAX
    ``fast2``, ``fast`` and ``exact`` outputs of that graph on
    ``converted_frames()`` (``converted_<bits>``, the frames' sha256
    ``converted_frames_sha256``) and of its 448 retarget on ``frames448()``
    in ``fast2`` and ``exact`` (``converted448_<bits>``); and the JAX
    ONNX evaluator's output on the shipped ``checkpoints/yoloface_corpus
    .onnx`` for ``onnx_inputs()`` (``onnx_corpus_eval``).
chip_smoke.py holds the card's output against it without jax;
tests/test_torch_pipeline.py, tests/test_torch_tiled.py,
tests/test_torch_fused.py, tests/test_torch_perop.py and
tests/test_torch_arena.py recompute the JAX side and hold it against the
file.  ``GraphMaker``, which builds the op-surface graph, also builds the
one-op graphs of tests/test_torch_perop.py and the published yolov3-tiny
(``yolov3_tiny_graph``).

Run from the repository root, on the CPU:
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py
or, to add the detections of the FPN, the protocol text or the
interchange keys (which also writes the converted graph; it needs
TensorFlow) to the file as it is (every other array kept as it was):
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --add multihead
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --add protocol
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --add interchange
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
# the v3-tiny FPN's two heads as tests/test_darknet_ptq.py decodes them,
# (grid, stride, anchors) each, and the rest of its detect_multihead call
FPN_HEADS = ((4, 8, ((9, 14), (12, 17), (22, 21))),
             (8, 4, ((4, 7), (6, 8), (11, 10))))
FPN_DETECT = {"input_size": 32.0, "conf_threshold": 0.5}
MULTIHEAD_PARTS = ("boxes", "scores", "valid")


def tflite_key(name: str, bits: str, k: int) -> str:
    """The golden key of output ``k`` of a .tflite test graph."""
    return f"tflite_{name}_{bits}{k}"


def multihead_key(bits: str, part: str) -> str:
    """The golden key of one part of the FPN's detections in ``bits``."""
    return f"multihead_v3tiny_fpn_{bits}_{part}"


KEYS_MULTIHEAD = tuple(multihead_key(bits, part)
                       for bits in ("fast2", "fast", "exact")
                       for part in MULTIHEAD_PARTS)
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


def wide_move_graphs():
    """The per-op programs past the byte-move kernels' limits, in the port's
    IR (numpy only), each with its int8 input shape: "17-input concat", a
    CONCATENATION of 17 inputs (x, its RELU and its RELU6 in turn: three
    distinct tensors) of [N,4,4,3] -> [N,4,4,51]; "17 distinct inputs", a
    CONCATENATION of x [N,4,4,3] and 16 standalone LEAKY_RELUs of it, each
    with its own output scale and zero-point (17 distinct tensors) ->
    [N,4,4,51]; "16400 channels", x [N,1,2,8200] concatenated with its RELU
    to 16,400 channels, then a x2 RESIZE of those to [N,2,4,16400]; "17
    distinct inputs past 16,384 channels", a CONCATENATION of x [N,1,2,1000]
    and 16 standalone LEAKY_RELUs of it, each with its own output scale and
    zero-point (17 distinct tensors) -> [N,1,2,17000]."""
    b = GraphMaker(SEED_SURFACE)
    x = b.act(4, 3, 0.05, -3)
    ts = [x, b.op("RELU", [x], b.act(4, 3, 0.05, -3)),
          b.op("RELU6", [x], b.act(4, 3, 0.05, -3))]
    cat = b.op("CONCATENATION", [ts[k % 3] for k in range(17)],
               b.act(4, 51, 0.05, -3), axis=3, activation="NONE")
    many = b.graph([x], [cat], "concat17")
    b = GraphMaker(SEED_SURFACE)
    x = b.act(4, 3, 0.05, -3)
    ts = [x] + [b.op("LEAKY_RELU", [x], b.act(4, 3, 0.04 + 0.005 * k,
                                                 7 * k - 50), alpha=0.1)
                for k in range(16)]
    cat = b.op("CONCATENATION", ts, b.act(4, 51, 0.05, -3), axis=3,
               activation="NONE")
    distinct = b.graph([x], [cat], "concat17_distinct")
    b = GraphMaker(SEED_SURFACE)
    x = b.tensor((1, 1, 2, 8200), scale=0.05, zp=-3)
    r = b.op("RELU", [x], b.tensor((1, 1, 2, 8200), scale=0.05, zp=-3))
    cat = b.op("CONCATENATION", [x, r], b.tensor((1, 1, 2, 16400),
                                                 scale=0.05, zp=-3),
               axis=3, activation="NONE")
    size = b.tensor((2,), np.int32, data=np.asarray([2, 4], np.int32))
    up = b.op("RESIZE_NEAREST_NEIGHBOR", [cat, size],
              b.tensor((1, 2, 4, 16400), scale=0.05, zp=-3),
              align_corners=False, half_pixel_centers=False)
    wide = b.graph([x], [up], "channels16400")
    b = GraphMaker(SEED_SURFACE)
    x = b.tensor((1, 1, 2, 1000), scale=0.05, zp=-3)
    ts = [x] + [b.op("LEAKY_RELU", [x],
                     b.tensor((1, 1, 2, 1000), scale=0.04 + 0.005 * k,
                              zp=7 * k - 50), alpha=0.1)
                for k in range(16)]
    cat = b.op("CONCATENATION", ts, b.tensor((1, 1, 2, 17000), scale=0.05,
                                             zp=-3),
               axis=3, activation="NONE")
    wide_distinct = b.graph([x], [cat], "concat17_distinct_wide")
    return {"17-input concat": (many, (4, 4, 3)),
            "17 distinct inputs": (distinct, (4, 4, 3)),
            "16400 channels": (wide, (1, 2, 8200)),
            "17 distinct inputs past 16,384 channels": (wide_distinct,
                                                        (1, 2, 1000))}


def strided_1x1_graph():
    """A 1x1 conv with stride 2 through an absorbed PAD of 1 row on top
    and 1 column on the right, in the port's IR (numpy only): int8
    [N,7,7,6] -> [N,4,4,11].  Its window reads outside the image (the
    fill), and its 16 pixels and 11 channels leave the tensor-core
    body's m16 and n8 tiles ragged."""
    b = GraphMaker(5)
    x = b.act(7, 6, 0.05, -3)
    p = b.pad(x, [[0, 0], [1, 0], [0, 1], [0, 0]], b.act(8, 6, 0.05, -3))
    c = b.conv(p, 11, (1, 1), 2, "VALID", b.act(4, 11, 0.07, 5))
    return b.graph([x], [c], "strided_1x1")


def pool_graph():
    """Max-pools of one odd-sized 18-channel input, in the port's IR (numpy
    only): int8 [N,29,29,18] -> 8x8 and 4x4 at stride 2 SAME ([N,15,15,18];
    pads 3/4 and 1/2), 8x8 at stride 2 and 4x4 at stride 1 VALID
    ([N,11,11,18], [N,26,26,18]) and 9x9 at stride 2 SAME ([N,15,15,18];
    pads 4/4)."""
    b = GraphMaker(SEED_SURFACE)
    x = b.act(29, 18, 0.05, -3)
    outs = [b.op("MAX_POOL_2D", [x], b.act(size, 18, 0.05, -3),
                 padding=padding, stride_h=s, stride_w=s, filter_h=k,
                 filter_w=k, activation="NONE")
            for k, s, padding, size in ((8, 2, "SAME", 15), (4, 2, "SAME", 15),
                                        (8, 2, "VALID", 11),
                                        (4, 1, "VALID", 26),
                                        (9, 2, "SAME", 15))]
    return b.graph([x], outs, "pools_29x29x18")


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
def tie_heavy_heads(n: int, seed: int = 5, grid: int = 7) -> np.ndarray:
    """int8 heads [n,grid,grid,18] whose ranking keys tie a lot, for the
    top-K kernels: the first quarter of the frames saturate every
    confidence (127: every key the same), the second quarter hold every
    confidence below the threshold (-128: every key 0), the rest draw each
    confidence from six levels, two below the threshold and three that
    saturate the sigmoid in float32 at the corpus head's scale; the other
    channels random, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(-128, 128, (n, grid, grid, 18), dtype=np.int64)
    levels = np.array([-128, -20, 0, 120, 126, 127])
    conf = levels[rng.integers(0, len(levels), (n, grid, grid, 3))]
    conf[: n // 4] = 127
    conf[n // 4: n // 2] = -128
    y[..., 4::6] = conf
    return y.astype(np.int8)


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


def jax_outputs_multihead() -> dict:
    """JAX ``detect_multihead`` on the FPN's heads from its JAX ``fast2``,
    ``fast`` and ``exact`` engines on ``tflite_frames("v3tiny_fpn")``."""
    from yoloface_tpu.io.tflite_import import load_tflite
    from yoloface_tpu.pipeline.head import HeadConfig, detect_multihead
    from yoloface_tpu.runtime.engine import Int8Engine
    g = load_tflite(tflite_path("v3tiny_fpn"))
    qs = [g.tensor(o).qparams for o in g.outputs]
    cfgs = [HeadConfig(grid=grid, stride=stride, anchors=anchors)
            for grid, stride, anchors in FPN_HEADS]
    out = {}
    for bits in ("fast2", "fast", "exact"):
        heads = Int8Engine(g, bits)(tflite_frames("v3tiny_fpn"))
        got = detect_multihead(heads, cfgs, scales=[q.scale for q in qs],
                               zero_points=[q.zero_point for q in qs],
                               **FPN_DETECT)
        out.update({multihead_key(bits, part): np.asarray(v)
                    for part, v in zip(MULTIHEAD_PARTS, got)})
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


KEYS_PROTOCOL = ("protocol_fast2", "protocol_exact")


def jax_outputs_protocol() -> dict:
    """The JAX package's firmware-protocol text of the golden frames: its
    ``CameraStreamer`` (the Python queue, so nothing is built) on one batch
    of the 8 frames around the ``fast2`` and ``exact`` pipelines of
    ``jax_outputs`` (``protocol_fast2``, ``protocol_exact``: the 8 frames'
    text, frames numbered from 1)."""
    from yoloface_tpu.host.streamer import CameraStreamer
    from yoloface_tpu.io.tflite_import import load_tflite
    from yoloface_tpu.pipeline.e2e import FacePipeline
    from yoloface_tpu.pipeline.head import HeadConfig
    from yoloface_tpu.runtime.engine import Int8Engine
    graph = load_tflite(CORPUS)
    frames = golden_frames()
    out = {}
    for mode, topk in (("fast2", False), ("exact", True)):
        pipe = FacePipeline(Int8Engine(graph, mode),
                            HeadConfig(use_fused_head=False,
                                       use_pallas_topk=topk))
        texts = []
        stats = CameraStreamer(pipe, iter([frames]), use_native=False).run(
            1, on_frame=texts.append)
        assert stats["frames"] == len(texts) == len(frames), stats
        out[f"protocol_{mode}"] = np.asarray("".join(texts))
    return out


SEED_CONVERTED, CONVERTED_REP = 21, 8
CONVERTED = os.path.join(REPO, "tests", "data",
                         "yoloface_converted_int8.tflite")
ONNX_CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus.onnx")
KEYS_INTERCHANGE = ("converted_fast2", "converted_fast", "converted_exact",
                    "converted_frames_sha256", "converted448_fast2",
                    "converted448_exact", "onnx_corpus_eval")


def converted_rep() -> np.ndarray:
    """The representative images of the converted graph (numpy only):
    ``CONVERTED_REP`` float32 [56,56,3] frames in [0, 1]."""
    rng = np.random.default_rng(SEED_CONVERTED)
    return rng.uniform(0, 1, (CONVERTED_REP, 56, 56, 3)).astype(np.float32)


def converted_frames() -> np.ndarray:
    """int8 [8,56,56,3] inputs of the converted graph (numpy only)."""
    rng = np.random.default_rng(SEED_CONVERTED + 1)
    return rng.integers(-128, 128, (8, 56, 56, 3), dtype=np.int64
                        ).astype(np.int8)


def onnx_inputs() -> np.ndarray:
    """float32 NCHW [4,3,56,56] inputs in [0, 1] of the shipped .onnx
    (numpy only)."""
    rng = np.random.default_rng(SEED_CONVERTED + 2)
    return rng.uniform(0, 1, (4, 3, 56, 56)).astype(np.float32)


def write_converted(path: str = CONVERTED) -> str:
    """The corpus weights through the port's TensorFlow chain into
    ``path``."""
    import tempfile

    from yoloface_tpu_torch.io.tflite_import import load_tflite
    from yoloface_tpu_torch.models.import_weights import (
        variables_from_template)
    from yoloface_tpu_torch.quantize import tf_convert
    variables = variables_from_template(load_tflite(CORPUS))
    with tempfile.TemporaryDirectory() as work:
        return tf_convert.checkpoint_to_int8_tflite(
            variables, path, work,
            rep_dataset=tf_convert.rep_dataset_from_arrays(converted_rep()))


def jax_outputs_interchange() -> dict:
    """The JAX engines on the converted graph and its 448 retarget, and
    the JAX ONNX evaluator on the shipped .onnx."""
    from yoloface_tpu.graph.retarget import retarget_spatial
    from yoloface_tpu.io.onnx_eval import OnnxEvaluator
    from yoloface_tpu.io.tflite_import import load_tflite
    from yoloface_tpu.runtime.engine import Int8Engine
    g = load_tflite(CONVERTED)
    x = converted_frames()
    out = {"converted_frames_sha256": np.array(sha256(x))}
    for bits in ("fast2", "fast", "exact"):
        out[f"converted_{bits}"] = np.asarray(Int8Engine(g, bits)(x))
    g448 = retarget_spatial(g, 8)
    for bits in ("fast2", "exact"):
        out[f"converted448_{bits}"] = np.asarray(
            Int8Engine(g448, bits)(frames448()))
    with open(ONNX_CORPUS, "rb") as f:
        out["onnx_corpus_eval"] = np.asarray(
            OnnxEvaluator(f.read())(onnx_inputs()))
    return out


def add_keys(new: dict) -> None:
    """Add ``new`` to the golden file, every array already there kept as
    it is (a key already there must hold the same array)."""
    old = dict(np.load(OUT))
    for k in set(old) & set(new):
        if not np.array_equal(old[k], new[k]):
            raise SystemExit(f"{k} differs from the golden file's")
    np.savez_compressed(OUT, **{**old, **new})


def main(argv) -> int:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    if argv == ["--add", "multihead"]:
        add_keys(jax_outputs_multihead())
        print(f"added {len(KEYS_MULTIHEAD)} keys to {OUT}")
        return 0
    if argv == ["--add", "protocol"]:
        add_keys(jax_outputs_protocol())
        print(f"added {len(KEYS_PROTOCOL)} keys to {OUT}")
        return 0
    if argv == ["--add", "interchange"]:
        write_converted()
        add_keys(jax_outputs_interchange())
        print(f"wrote {CONVERTED}; added {len(KEYS_INTERCHANGE)} keys to "
              f"{OUT}")
        return 0
    if argv:
        raise SystemExit("usage: make_torch_port_golden.py "
                         "[--add multihead|protocol|interchange]")
    frames = golden_frames()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    write_tflite_graphs()
    write_converted()
    np.savez_compressed(OUT, frames=frames, **jax_outputs(frames),
                        **jax_outputs_448(), **jax_outputs_surface(),
                        **jax_outputs_surface_fast2(), **jax_outputs_tflite(),
                        **jax_outputs_multihead(), **jax_outputs_protocol(),
                        **jax_outputs_interchange())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
