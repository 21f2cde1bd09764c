"""The per-op kernel family in the port (``kernels/perop.py``, engine modes
``perop`` and ``perop_exact``) against the JAX package on the CPU.

Tolerance 0 on every int8 tensor.  The JAX side runs as its own tests run
it: ``pallas`` / ``pallas_exact`` (``runtime/pallas_plan.py`` over the
``kernels/pallas_int8.py`` kernels) in interpret mode, and each of the
eleven kernels called directly on ``[C,W,H,N]`` inputs.  The graphs: the
corpus, the op-surface graph of ``tools/make_torch_port_golden.py``, fuzz
seeds of ``tests/test_tiled_fuzz.py`` (0, 2 and 5 by default: RELU in
each, seed 2 a concat, seed 5 a RESIZE; the others under ``slow``, as
``tests/test_arena_fuzz.py`` marks its slow seeds) and the two-headed
v3-tiny FPN of ``tests/test_darknet_ptq.py`` in both bits."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_darknet_ptq as ptq
from test_tiled_fuzz import _int8_graph
from yoloface_tpu.core.fixedpoint import quantize_multiplier
from yoloface_tpu.io.darknet_cfg import DarknetNet, template_from_darknet
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.kernels import pallas_int8 as pk
from yoloface_tpu.ops.int8_ref import _same_pad_amounts
from yoloface_tpu.quantize.calibrate import calibrate_from_weights
from yoloface_tpu.runtime import pallas_plan
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.kernels import arena, move, perop
from yoloface_tpu_torch.pipeline import head as thead
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime.engine import PEROP_BITS, Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
JAX_PEROP = {"fast": "pallas", "exact": "pallas_exact"}
MODE = {bits: mode for mode, bits in PEROP_BITS.items()}
B8 = tuple(perop.KERNELS)       # the eleven pallas_int8 kernels by name


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _golden_tool()         # numpy at import; jax only inside functions


def _int8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int64).astype(np.int8)


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=f"t{k}")


@pytest.fixture(scope="module")
def corpus():
    """The JAX corpus graph and 2 frames."""
    return (jax_load_tflite(CORPUS),
            _int8(np.random.default_rng(0), (2, 56, 56, 3)))


@pytest.mark.parametrize("bits", perop.BITS)
def test_corpus_every_tensor_equals_pallas(corpus, bits):
    """``perop[_exact]`` returns the 38 tensors JAX ``pallas[_exact]``
    returns (the input and each op output no epilogue absorbed), each
    equal; one program an op, the 17 conv+LEAKY pairs fused."""
    jg, x = corpus
    want = JaxEngine(jg, JAX_PEROP[bits]).run_with_intermediates(x)
    eng = Int8Engine(graph_from_jax(jg), MODE[bits], device="cpu")
    got = eng.run_with_intermediates(x)
    assert len(got) == len(want) == 38
    _assert_equal(got, want)
    stages = eng.arena.stages
    kernels = {k: sum(st.kernel == k for st in stages) for k in B8}
    assert kernels == {"conv1x1": 16, "dwconv3x3": 7, "conv3x3": 1,
                       "pad_int8": 3, "maxpool_int8": 2, "add_int8": 3,
                       "requantize_int8": 3, "concat_channels": 2,
                       "eltwise_int8": 0, "resize_nearest": 0,
                       "leaky_int8": 0}
    epis = np.concatenate([st.descs[:, arena.F["epi"]] for st in stages])
    fused_epi = (arena.EPI_LEAKY_EXACT if bits == "exact"
                 else arena.EPI_LEAKY_V1)
    assert (epis == fused_epi).sum() == 17
    assert all(st.arena_bytes == 0 for st in stages)
    for st in stages:                      # every view in device memory
        for p in ("in0", "out"):
            assert (st.descs[:, arena.F[p + "_space"]] >= 1).all()


@pytest.fixture(scope="module")
def surface():
    return TOOL, TOOL.surface_graph(), TOOL.surface_frames()


@pytest.mark.parametrize("bits", perop.BITS)
def test_op_surface_equals_pallas_and_golden(surface, bits):
    """Every one of the eleven kernels in one graph: each tensor equals JAX
    ``pallas[_exact]``, the outputs equal the golden keys."""
    tool, g, x = surface
    gold = np.load(GOLDEN)
    assert str(gold["surface_frames_sha256"]) == tool.sha256(x)
    eng = Int8Engine(g, MODE[bits], device="cpu")
    assert {st.kernel for st in eng.arena.stages} == set(B8)
    got = eng.run_with_intermediates(x)
    _assert_equal(got, JaxEngine(tool.jax_graph(g), JAX_PEROP[bits])
                  .run_with_intermediates(x))
    for k, y in enumerate(eng(torch.from_numpy(x))):
        np.testing.assert_array_equal(y.numpy(), gold[f"surface_{bits}{k}"])


@pytest.mark.parametrize("seed", [
    0, 2, 5, *(pytest.param(s, marks=pytest.mark.slow) for s in (1, 3, 4, 6,
                                                                 7))])
@pytest.mark.parametrize("bits", perop.BITS)
def test_fuzz_every_tensor_equals_pallas(seed, bits):
    jg, rng = _int8_graph(seed)
    x = _int8(rng, (2, 14, 14, 3))
    want = JaxEngine(jg, JAX_PEROP[bits]).run_with_intermediates(x)
    got = Int8Engine(graph_from_jax(jg), MODE[bits],
                     device="cpu").run_with_intermediates(x)
    _assert_equal(got, want)


@pytest.fixture(scope="module")
def v3tiny():
    """tests/test_darknet_ptq.py's two-headed v3-tiny FPN, int8."""
    net = DarknetNet(ptq.V3_TINY_CFG)
    template, weights = template_from_darknet(net, ptq._random_params(net))
    rep = np.random.default_rng(5).uniform(0, 1, (16, 32, 32, 3))
    return calibrate_from_weights(weights, rep.astype(np.float32), template)


@pytest.mark.parametrize("bits", perop.BITS)
def test_v3tiny_both_heads_equal_pallas(v3tiny, bits):
    """RESIZE, a 1-input concat, a leaky read twice, two graph outputs in
    order: every tensor and both heads equal JAX ``pallas[_exact]``."""
    x = _int8(np.random.default_rng(11), (2, 32, 32, 3))
    want = JaxEngine(v3tiny, JAX_PEROP[bits]).run_with_intermediates(x)
    eng = Int8Engine(graph_from_jax(v3tiny), MODE[bits], device="cpu")
    _assert_equal(eng.run_with_intermediates(x), want)
    got = eng(torch.from_numpy(x))
    assert len(got) == len(v3tiny.outputs) == 2
    for y, o in zip(got, v3tiny.outputs):
        np.testing.assert_array_equal(y.numpy(), want[o])


# --------------------------------------------------------------------------
# each kernel on its own: the JAX function called directly
# --------------------------------------------------------------------------
def _graph():
    """A maker of one-op (or conv+LEAKY) graphs in the port's IR."""
    return TOOL.GraphMaker(3)


def _act(b, h, w, c, scale=0.05, zp=-3):
    return b.tensor((1, h, w, c), scale=scale, zp=zp)


def _conv_case(kh, kw, stride, padding, depthwise=False, leaky=False,
               co=12, hw=(9, 11), ci=6):
    def make():
        b = _graph()
        x = _act(b, *hw, ci)
        oh, ow = ((-(-d // stride)) if padding == "SAME"
                  else (d - k) // stride + 1 for d, k in zip(hw, (kh, kw)))
        co_ = ci if depthwise else co
        c = b.conv(x, co_, (kh, kw), stride, padding,
                   _act(b, oh, ow, co_, 0.09, 6), depthwise)
        y = (b.op("LEAKY_RELU", [c], _act(b, oh, ow, co_, 0.07, -20),
                  alpha=0.1) if leaky else c)
        return b.graph([x], [y])
    return make


def _jax_conv(jg, exact, x):
    """pallas_plan's conv glue: bias_eff, the requant (and fused leaky)
    specs, SAME padding by pad_int8, then the kernel."""
    op = jg.ops[0]
    leaky_op = jg.ops[1] if len(jg.ops) > 1 else None
    t = jg.tensor
    w, b = t(op.inputs[1]), t(op.inputs[2])
    in_q, out_q = t(op.inputs[0]).qparams, t(op.outputs[0]).qparams
    rq = pallas_plan._requant_spec(in_q.scale, w.qparams.scales, out_q.scale,
                                   out_q.zero_point, exact)
    lk = (None if leaky_op is None
          else pallas_plan._leaky_spec(jg, leaky_op, exact))
    wd = w.data
    dw = op.opname == "DEPTHWISE_CONV_2D"
    axes = (0, 1, 2) if dw else (1, 2, 3)
    bias = (b.data.astype(np.int64)
            - in_q.zero_point * wd.astype(np.int64).sum(axes)).astype(np.int32)
    pk.set_conv_bounds(rq, np.abs(wd.astype(np.int64)).sum(axes), bias)
    s, (kh, kw) = op.attrs["stride_h"], wd.shape[1:3]
    if (kh, kw) == (1, 1) and not dw:
        return pk.conv1x1(x, np.ascontiguousarray(wd[:, 0, 0, :].T), bias,
                          rq, lk)
    (in_h, in_w), (oh, ow) = (t(op.inputs[0]).shape[1:3],
                              t(op.outputs[0]).shape[1:3])
    if op.attrs["padding"] == "SAME":
        x = pk.pad_int8(x, (_same_pad_amounts(in_w, s, kw),
                            _same_pad_amounts(in_h, s, kh)), in_q.zero_point)
    if dw:
        return pk.dwconv3x3(x, np.ascontiguousarray(wd[0].transpose(2, 1, 0)),
                            bias, rq, stride=s, out_hw=(ow, oh), leaky=lk)
    return pk.conv3x3(x, np.ascontiguousarray(wd.transpose(0, 3, 2, 1)),
                      bias, rq, stride=s, out_hw=(ow, oh), leaky=lk)


def _unary(name, out_q=(0.05, -3), hw=(6, 7), c=5, **attrs):
    def make():
        b = _graph()
        x = _act(b, *hw, c)
        b.op(name, [x], _act(b, *hw, c, *out_q), **attrs)
        return b.graph([x], [1])
    return make


def _pad_case():
    b = _graph()
    x = _act(b, 6, 7, 5)
    b.pad(x, [[0, 0], [1, 2], [2, 0], [0, 0]], _act(b, 9, 9, 5))
    return b.graph([x], [1])


def _pool_case(k, stride, padding, hw=(9, 8)):
    def make():
        b = _graph()
        x = _act(b, *hw, 6)
        oh, ow = ((-(-d // stride)) if padding == "SAME"
                  else (d - k) // stride + 1 for d in hw)
        b.op("MAX_POOL_2D", [x], _act(b, oh, ow, 6), padding=padding,
             stride_h=stride, stride_w=stride, filter_h=k, filter_w=k,
             activation="NONE")
        return b.graph([x], [1])
    return make


def _add_case():
    b = _graph()
    xa, xb = _act(b, 6, 7, 5, 0.05, -3), _act(b, 6, 7, 5, 0.11, 9)
    b.op("ADD", [xa, xb], _act(b, 6, 7, 5, 0.09, 4))
    return b.graph([xa, xb], [2])


def _concat_case(widths):
    def make():
        b = _graph()
        xs = [_act(b, 5, 6, c) for c in widths]
        b.op("CONCATENATION", xs, _act(b, 5, 6, sum(widths)), axis=3,
             activation="NONE")
        return b.graph(xs, [len(xs)])
    return make


def _resize_case():
    b = _graph()
    x = _act(b, 4, 5, 6)
    size = b.tensor((2,), np.int32, data=np.asarray([8, 15], np.int32))
    b.op("RESIZE_NEAREST_NEIGHBOR", [x, size], _act(b, 8, 15, 6),
         align_corners=False, half_pixel_centers=False)
    return b.graph([x], [2])


def _jax_op(jg, exact, *xs):
    """pallas_plan's glue for the other ops, then the kernel."""
    op, t = jg.ops[0], jg.tensor
    name, (x, *rest) = op.opname, xs
    if name == "PAD":
        p = t(op.inputs[1]).data.astype(int)
        return pk.pad_int8(x, ((p[2][0], p[2][1]), (p[1][0], p[1][1])),
                           t(op.outputs[0]).qparams.zero_point)
    if name == "MAX_POOL_2D":
        a = op.attrs
        (h, w), (oh, ow) = t(op.inputs[0]).shape[1:3], t(op.outputs[0]).shape[
            1:3]
        pads = ((0, 0), (0, 0))
        if a["padding"] == "SAME":
            pads = (_same_pad_amounts(w, a["stride_w"], a["filter_w"]),
                    _same_pad_amounts(h, a["stride_h"], a["filter_h"]))
        return pk.maxpool_int8(x, filter_hw=(a["filter_w"], a["filter_h"]),
                               stride=a["stride_h"], pads=pads,
                               out_hw=(ow, oh))
    if name == "ADD":
        q1, q2 = t(op.inputs[0]).qparams, t(op.inputs[1]).qparams
        qo = t(op.outputs[0]).qparams
        s1, s2, so = (np.float64(q.scale) for q in (q1, q2, qo))
        spec = {"exact": exact, "zp1": q1.zero_point, "zp2": q2.zero_point,
                "zp_out": qo.zero_point}
        if exact:
            twice = 2.0 * max(s1, s2)
            spec["left_shift"] = 20
            spec["qm1"], spec["sh1"] = quantize_multiplier(
                s1 / twice)
            spec["qm2"], spec["sh2"] = quantize_multiplier(
                s2 / twice)
            spec["qmo"], spec["sho"] = quantize_multiplier(
                twice / ((1 << 20) * so))
        else:
            spec["s1"], spec["s2"] = np.float32(s1 / so), np.float32(s2 / so)
        return pk.add_int8(x, rest[0], spec)
    if name == "QUANTIZE":
        qi, qo = t(op.inputs[0]).qparams, t(op.outputs[0]).qparams
        ratio = np.float64(qi.scale) / np.float64(qo.scale)
        spec = {"exact": exact, "zp_in": qi.zero_point,
                "zp_out": qo.zero_point}
        if exact:
            spec["qm"], spec["sh"] = quantize_multiplier(ratio)
        else:
            spec["scale"] = np.float32(ratio)
        return pk.requantize_int8(x, spec)
    if name == "CONCATENATION":               # JAX folds it pairwise
        for y in rest:
            x = pk.concat_channels(x, y)
        return x
    if name in ("RELU", "RELU6", "LOGISTIC"):
        return pk.eltwise_int8(x, pk.activation_int32(
            name, t(op.inputs[0]).qparams))
    if name == "RESIZE_NEAREST_NEIGHBOR":
        return pk.resize_nearest(x, pk.resize_factors(t, op))
    assert name == "LEAKY_RELU"
    return pk.leaky_int8(x, pallas_plan._leaky_spec(jg, op, exact))


# case: (graph maker, the JAX side, the B8 kernel, bits it runs in)
KERNEL_CASES = {
    "conv1x1": (_conv_case(1, 1, 1, "SAME"), _jax_conv, "conv1x1",
                perop.BITS),
    "conv1x1 + leaky": (_conv_case(1, 1, 1, "VALID", leaky=True), _jax_conv,
                        "conv1x1", perop.BITS),
    "dwconv3x3 s1 SAME + leaky": (
        _conv_case(3, 3, 1, "SAME", depthwise=True, leaky=True), _jax_conv,
        "dwconv3x3", perop.BITS),
    "dwconv3x3 s2 SAME": (_conv_case(3, 3, 2, "SAME", depthwise=True),
                          _jax_conv, "dwconv3x3", perop.BITS),
    "dwconv3x3 s2 VALID": (_conv_case(3, 3, 2, "VALID", depthwise=True),
                           _jax_conv, "dwconv3x3", perop.BITS),
    "conv3x3 s1 SAME": (_conv_case(3, 3, 1, "SAME"), _jax_conv, "conv3x3",
                        perop.BITS),
    "conv3x3 s2 VALID + leaky": (_conv_case(3, 3, 2, "VALID", leaky=True,
                                            ci=3, co=8), _jax_conv,
                                 "conv3x3", perop.BITS),
    "conv 3x1 s1 SAME": (_conv_case(3, 1, 1, "SAME"), _jax_conv, "conv3x3",
                         perop.BITS),
    "pad_int8": (_pad_case, _jax_op, "pad_int8", ("fast",)),
    "maxpool 3x3 s2 SAME": (_pool_case(3, 2, "SAME"), _jax_op,
                            "maxpool_int8", ("fast",)),
    "maxpool 2x2 s2 VALID": (_pool_case(2, 2, "VALID"), _jax_op,
                             "maxpool_int8", ("fast",)),
    "add_int8": (_add_case, _jax_op, "add_int8", perop.BITS),
    "requantize_int8": (_unary("QUANTIZE", (0.021, 4)), _jax_op,
                        "requantize_int8", perop.BITS),
    "concat 2 inputs": (_concat_case((3, 5)), _jax_op, "concat_channels",
                        ("fast",)),
    "concat 3 inputs": (_concat_case((4, 2, 6)), _jax_op, "concat_channels",
                        ("fast",)),
    "RELU": (_unary("RELU"), _jax_op, "eltwise_int8", ("fast",)),
    "RELU6": (_unary("RELU6"), _jax_op, "eltwise_int8", ("fast",)),
    "LOGISTIC": (_unary("LOGISTIC", (1.0 / 256.0, -128)), _jax_op,
                 "eltwise_int8", ("fast",)),
    "resize_nearest": (_resize_case, _jax_op, "resize_nearest", ("fast",)),
    "leaky_int8": (_unary("LEAKY_RELU", (0.07, -20), alpha=0.1), _jax_op,
                   "leaky_int8", perop.BITS),
}


@pytest.mark.parametrize("case,bits", [(c, b) for c, v in KERNEL_CASES.items()
                                       for b in v[3]])
def test_each_kernel_equals_its_jax_function(case, bits):
    """The JAX kernel on ``[C,W,H,N]`` inputs against the port's one-op
    program on the same inputs in NHWC (3 frames, seeded)."""
    make, jax_side, kernel, _ = KERNEL_CASES[case]
    g = make()
    (st,) = perop.build_perop_plan(g, bits)
    assert st.kernel == kernel
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(case))
    xs = [_int8(rng, (3,) + st.shapes[i]) for i in st.inputs]
    got = perop.perop_op(st, torch.from_numpy(st.descs),
                         torch.from_numpy(st.consts),
                         [torch.from_numpy(x) for x in xs])[0].numpy()
    want = jax_side(TOOL.jax_graph(g), bits == "exact",
                    *[jnp.asarray(x.transpose(3, 2, 1, 0)) for x in xs])
    assert len(np.unique(got)) > 2                        # the op acts
    np.testing.assert_array_equal(got, np.asarray(want).transpose(3, 2, 1, 0))


# --------------------------------------------------------------------------
# refusals, serving, routing
# --------------------------------------------------------------------------
def _set(op, **attrs):
    return lambda g: g.ops[op].attrs.update(attrs)


def _tensor(idx, data):
    def change(g):
        g.tensors[idx].data = data
    return change


REFUSALS = {   # the op-surface graph with one thing JAX's per-op lowering
    # computes wrongly (ROADMAP C)
    "conv stride 2x1": (_set(1, stride_w=1), "stride 2x1"),
    "depthwise stride 2x1": (_set(3, stride_w=1), "stride 2x1"),
    "pool stride 2x1": (_set(14, stride_w=1), "stride 2x1"),
    "conv stride 3": (_set(1, stride_h=3, stride_w=3), "stride 1 or 2"),
    "concat off channels": (_set(12, axis=1), "off the channel axis"),
    "1x1 stride 2": (_set(4, stride_h=2, stride_w=2), "1x1 with stride 2"),
    "depthwise 5x5": (_tensor(8, np.ones((1, 5, 5, 8), np.int8)),
                      "depthwise convs are 3x3"),
    "dilation": (_set(1, dilation_h=2, dilation_w=2), "dilation"),
    "pad channels": (_tensor(2, np.asarray([[0, 0], [1, 1], [1, 1], [0, 1]],
                                           np.int32)),
                     "pads batch or channels"),
    "fused activation": (_set(1, activation="RELU"), "fused activation"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_perop_plan_refuses(case):
    change, match = REFUSALS[case]
    g = TOOL.surface_graph()
    change(g)
    for bits in perop.BITS:
        with pytest.raises(NotImplementedError, match=match):
            perop.build_perop_plan(g, bits)


def test_exact_bits_refuse_what_the_domain_check_refuses():
    """A QUANTIZE whose exact left shift leaves int32 is refused in
    ``perop_exact`` and planned in ``perop``."""
    b = _graph()
    x = b.tensor((1, 4, 4, 2), scale=1.0)
    b.op("QUANTIZE", [x], b.tensor((1, 4, 4, 2), scale=2.0 ** -24))
    g = b.graph([x], [1])
    perop.build_perop_plan(g, "fast")
    with pytest.raises(NotImplementedError, match="int32"):
        perop.build_perop_plan(g, "exact")


@pytest.mark.parametrize("mode,key", [("perop", "head_fast"),
                                      ("perop_exact", "head_exact")])
def test_serving_on_golden_frames(mode, key):
    """``load_pipeline(corpus, mode, device="cpu")`` (the preprocess, per-op
    and head kernels' plain versions) gives the golden int8 head; in exact
    bits the golden detections too."""
    gold = dict(np.load(GOLDEN))
    pipe = load_pipeline(CORPUS, mode=mode, device="cpu")
    head = pipe.engine(pipe.preprocess(gold["frames"]))
    np.testing.assert_array_equal(head.numpy(), gold[key])
    got = pipe.detect_rgb565(gold["frames"])
    if mode == "perop_exact":
        for k in ("valid", "count"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          gold["exact_" + k])
        np.testing.assert_allclose(np.asarray(got["boxes"]),
                                   gold["exact_boxes"], rtol=0,
                                   atol=thead.BOX_ATOL)
        np.testing.assert_allclose(np.asarray(got["scores"]),
                                   gold["exact_scores"], rtol=0,
                                   atol=thead.SCORE_ATOL)
    assert got["count"].sum() >= 7


@pytest.mark.parametrize("bits", perop.BITS)
def test_card_kernel_routes_by_the_program(corpus, surface, bits):
    """``card_kernel`` decides from the program: the 16,400-channel concat
    and the 16,400-channel resize (past the concat and resize kernels'
    16,384 channels) and the 17,000-channel concat of 17 distinct inputs
    go to the fused-stage kernel; the concats of 17
    inputs (3 and 17 distinct tensors) stay on the concat kernel, which
    ``perop_op`` launches once a group of 16 inputs, and the 16 standalone
    LEAKYs before the second go to the table kernel; every program of the
    corpus and the op surface keeps its own kernel: the table kernel for
    the activations, standalone LEAKYs and QUANTIZEs, the flat ADD kernel
    for the ADDs."""
    wide = TOOL.wide_move_graphs()
    got = {name: [perop.card_kernel(st)
                  for st in perop.PerOpPlan(g, bits).stages
                  if st.kernel != "eltwise_int8"]
           for name, (g, _) in wide.items()}
    assert got == {"17-input concat": ["concat_channels"],
                   "17 distinct inputs": ["eltwise_lut"] * 16
                   + ["concat_channels"],
                   "16400 channels": ["fused_stage", "fused_stage"],
                   "17 distinct inputs past 16,384 channels":
                   ["eltwise_lut"] * 16 + ["fused_stage"]}
    for g in (graph_from_jax(corpus[0]), surface[1]):
        for st in perop.PerOpPlan(g, bits).stages:
            want = ("eltwise_lut" if st.kernel in perop.TABLE_KERNELS else
                    st.kernel if st.kernel in perop.OWN_KERNELS
                    or st.kernel == perop.ADD_KERNEL else "fused_stage")
            assert perop.card_kernel(st) == want, st.kernel


@pytest.mark.parametrize("bits", perop.BITS)
@pytest.mark.parametrize("name,jax_mode", [("17-input concat", "pallas"),
                                           ("16400 channels", "exact")])
def test_wide_move_programs_equal_jax(name, jax_mode, bits):
    """The programs past the move kernels' limits equal JAX: the 17-input
    concat JAX ``pallas`` (its pairwise fold of ``concat_channels``, in
    interpret mode), the 16,400-channel concat and resize JAX ``exact``
    (a byte move is the same in every mode)."""
    g, shape = TOOL.wide_move_graphs()[name]
    x = _int8(np.random.default_rng(19), (2, *shape))
    want = JaxEngine(TOOL.jax_graph(g), jax_mode).run_with_intermediates(x)
    got = Int8Engine(g, MODE[bits], device="cpu").run_with_intermediates(x)
    assert set(got) <= set(want) and g.outputs[0] in got
    _assert_equal(got, {k: want[k] for k in got})


@pytest.mark.parametrize("bits,jax_mode", [("fast", "pallas"),
                                           ("exact", "exact"),
                                           ("exact", "pallas_exact")])
def test_concat_of_17_distinct_tensors_equals_jax(bits, jax_mode):
    """The concat of x and 16 LEAKY_RELUs of it (17 distinct tensors, past
    the fused-stage kernel's 16 device tensors) equals JAX on every
    tensor: ``perop`` JAX ``pallas`` (the leaky and concat kernels in
    interpret mode), ``perop_exact`` JAX ``exact`` and ``pallas_exact``;
    on the card it runs on the concat kernel in two groups."""
    g, shape = TOOL.wide_move_graphs()["17 distinct inputs"]
    x = _int8(np.random.default_rng(29), (2, *shape))
    want = JaxEngine(TOOL.jax_graph(g), jax_mode).run_with_intermediates(x)
    got = Int8Engine(g, MODE[bits], device="cpu").run_with_intermediates(x)
    assert len(set(g.ops[-1].inputs)) == 17 and g.outputs[0] in got
    assert set(got) <= set(want)
    _assert_equal(got, {k: want[k] for k in got})
    (cat,) = [st for st in perop.PerOpPlan(g, bits).stages
              if st.kernel == "concat_channels"]
    assert perop.card_kernel(cat) == "concat_channels"
    assert len(cat.args) == 17 > move.MAX_INPUTS


@pytest.mark.parametrize("bits,jax_mode", [("fast", "pallas"),
                                           ("exact", "pallas_exact")])
def test_wide_concat_of_17_distinct_tensors_equals_jax(bits, jax_mode):
    """The concat of x and 16 LEAKY_RELUs of it past 16,384 channels (17
    distinct tensors of 1,000 channels, past both the concat kernel's
    16,384 channels and the fused-stage kernel's 16 device tensors)
    equals JAX ``pallas`` / ``pallas_exact`` (interpret mode) on every
    tensor; on the card it runs on the fused-stage kernel in two parts."""
    g, shape = TOOL.wide_move_graphs()[
        "17 distinct inputs past 16,384 channels"]
    x = _int8(np.random.default_rng(31), (2, *shape))
    want = JaxEngine(TOOL.jax_graph(g), jax_mode).run_with_intermediates(x)
    got = Int8Engine(g, MODE[bits], device="cpu").run_with_intermediates(x)
    assert len(set(g.ops[-1].inputs)) == 17 and g.outputs[0] in got
    assert set(got) <= set(want)
    _assert_equal(got, {k: want[k] for k in got})


@pytest.mark.parametrize("bits", perop.BITS)
def test_concat_parts_rebuild_the_wide_concat(bits):
    """``perop.concat_parts`` cuts the 17,000-channel concat of 17 distinct
    tensors into fused-stage programs of 15 and 2 inputs (16 and 3 device
    tensors), each row writing the channel slice it wrote in the whole
    program; run one after the other into one output by the plain
    version, they give the whole program's output.  A program that fits
    one launch is its own one part."""
    g, shape = TOOL.wide_move_graphs()[
        "17 distinct inputs past 16,384 channels"]
    plan = perop.PerOpPlan(g, bits)
    x = torch.from_numpy(_int8(np.random.default_rng(5), (3, *shape)))
    env = plan.run_stages(x)
    (k,) = [k for k, st in enumerate(plan.stages)
            if st.kernel == "concat_channels"]
    st = plan.stages[k]
    parts = perop.concat_parts(st)
    assert [(len(p.inputs), idx) for p, idx in parts] == [
        (15, list(range(15))), (2, [15, 16])]
    for p, idx in parts:
        assert len(p.globals_) <= arena.MAX_GLOBALS
        assert p.outputs == st.outputs and p.descs.shape[1] == arena.OP_INTS
        assert set(p.descs[:, arena.F["out_space"]]) == {len(idx) + 1}
    assert np.array_equal(np.concatenate([p.descs for p, _ in parts])[
        :, arena.F["out_off"]], np.sort(st.descs[:, arena.F["out_off"]]))
    ins = [env[i] for i in st.inputs]
    out = torch.zeros_like(env[st.outputs[0]])
    for p, idx in parts:
        perop.perop_plain(p, getattr(plan, f"consts{k}"),
                          [ins[j] for j in idx] + [out])
    assert torch.equal(out, env[st.outputs[0]])
    small = [s for s in perop.PerOpPlan(
        TOOL.wide_move_graphs()["16400 channels"][0], bits).stages
        if s.kernel == "concat_channels"][0]
    assert perop.concat_parts(small) == [(small, [0, 1])]


def test_prepare_takes_checked_outputs():
    """``arena.prepare(stage, xs, outs)`` hands back the caller's output
    tensors (the concat parts share one) after checking them."""
    g, shape = TOOL.wide_move_graphs()[
        "17 distinct inputs past 16,384 channels"]
    st = [s for s in perop.PerOpPlan(g, "fast").stages
          if s.kernel == "concat_channels"][0]
    xs = [torch.zeros((2, *st.shapes[i]), dtype=torch.int8)
          for i in st.inputs]
    out = torch.zeros((2, *st.shapes[st.outputs[0]]), dtype=torch.int8)
    got, dev = arena.prepare(st, xs, [out])
    assert got[0] is out and dev.type == "cpu"
    for bad in (out[:1], out.to(torch.uint8), out[..., ::2]):
        with pytest.raises(ValueError, match="output"):
            arena.prepare(st, xs, [bad])


def test_default_device_is_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there "
                    "(tests/test_torch_gpu.py)")
    for mode in PEROP_BITS:
        with pytest.raises(RuntimeError, match="CUDA"):
            Int8Engine(graph_from_jax(corpus[0]), mode)
        with pytest.raises(RuntimeError, match="CUDA"):
            load_pipeline(CORPUS, mode=mode)


def test_forward_frees_each_tensor_after_its_last_reader(corpus):
    """``run_stages(x, free=True)``, which ``forward`` takes, ends holding
    the graph output alone; the output equals the full run's."""
    plan = perop.PerOpPlan(graph_from_jax(corpus[0]))
    x = torch.from_numpy(corpus[1])
    env = plan.run_stages(x, free=True)
    assert sorted(env) == plan.output_idxs
    full = plan.run_stages(x)
    assert torch.equal(env[plan.output_idxs[0]], full[plan.output_idxs[0]])


def test_wrapper_routes_by_device(corpus):
    """CPU tensors take the plain version (no launch counted); a tensor on
    another device raises."""
    plan = perop.PerOpPlan(graph_from_jax(corpus[0]))
    st = plan.stages[0]
    x = torch.from_numpy(corpus[1])
    perop.reset_launches()
    (out,) = perop.perop_op(st, plan.descs0, plan.consts0, [x])
    assert perop.perop_op.launches == 0 and not perop.perop_op.by_kernel
    ref = torch.empty_like(out)
    perop.perop_plain(st, plan.consts0, [x, ref])
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="no per-op kernel"):
        perop.perop_op(st, plan.descs0.to("meta"), plan.consts0.to("meta"),
                       [x.to("meta")])
