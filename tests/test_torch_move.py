"""The per-op byte-move kernels (``kernels/move.py``:
``csrc/resize_nearest.cu``, ``csrc/concat_channels.cu``,
``csrc/pad_int8.cu``) against the JAX package on the CPU.

Tolerance 0 everywhere: a resize, a concat and a pad move bytes.  The
plain versions equal JAX's ``pallas_int8.resize_nearest``,
``concat_channels`` and ``pad_int8`` on ``[C,W,H,N]`` transposes of the
same seeded inputs (in interpret mode, as ``tests/test_torch_perop.py``
runs the per-op kernels; a concat of three inputs through two pairwise JAX
concats, as JAX's per-op lowering folds it), and the per-op programs'
plain executor (``perop.perop_plain``) on the corpus net's three pads and
two concats, the op surface's two pads, resize and 3-input concat and the
yolov3-tiny FPN upsample.  The kernels
themselves run on the card only (``tests/test_torch_gpu.py``); here the
wrappers take their plain versions."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.kernels import pallas_int8 as pk
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena, eltwise, fused, move, perop
from yoloface_tpu_torch.runtime.engine import PEROP_BITS, Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
F = arena.F


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load("make_torch_port_golden",
             os.path.join(REPO, "tools", "make_torch_port_golden.py"))
SMOKE = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))


def _int8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int64).astype(np.int8)


def _cwhn(x):
    """NHWC numpy -> the per-op plans' [C,W,H,N] JAX layout (and back)."""
    return x.transpose(3, 2, 1, 0)


# --------------------------------------------------------------------------
# the plain versions against the JAX kernels
# --------------------------------------------------------------------------
# (N, H, W, C), kh, kw: the op surface's 4x4x8, C = 3 / 5 / 18, the FPN
# upsample's 13x13x128, factors 2x2, 2x3, 3x1
RESIZES = [((3, 4, 4, 8), 2, 2), ((2, 15, 15, 3), 2, 3),
           ((3, 7, 5, 5), 3, 1), ((2, 14, 14, 18), 2, 2),
           ((2, 13, 13, 128), 2, 2)]


@pytest.mark.parametrize("shape,kh,kw", RESIZES)
def test_resize_plain_equals_jax(shape, kh, kw):
    x = _int8(np.random.default_rng(sum(shape) + kh), shape)
    want = _cwhn(np.asarray(pk.resize_nearest(jnp.asarray(_cwhn(x)),
                                              (kw, kh))))
    got = move.resize_nearest(torch.from_numpy(x), kh, kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        move.resize_nearest_plain(torch.from_numpy(x), kh, kw).numpy(), want)


# input channel counts: the corpus concats, the op surface's three
# inputs, 3 + 5 + 18
CONCATS = [(18, 18), (24, 24), (8, 8, 8), (3, 5, 18)]


@pytest.mark.parametrize("widths", CONCATS)
def test_concat_plain_equals_pairwise_jax(widths):
    rng = np.random.default_rng(sum(widths))
    xs = [_int8(rng, (3, 5, 6, c)) for c in widths]
    want = jnp.asarray(_cwhn(xs[0]))
    for x in xs[1:]:                  # JAX's per-op lowering, pairwise
        want = pk.concat_channels(want, jnp.asarray(_cwhn(x)))
    got = move.concat_channels([torch.from_numpy(x) for x in xs])
    np.testing.assert_array_equal(got.numpy(), _cwhn(np.asarray(want)))


# (N, H, W, C), (pt, pb, pl, pr), fill: the corpus net's three PADs (its
# zero-points), asymmetric pads with a pad of 0 on a side, C = 1, 5 and
# 128, fills -128, 0 and 127, no pad at all
PADS = [((2, 56, 56, 3), (1, 0, 1, 0), -128),
        ((2, 28, 28, 18), (1, 0, 1, 0), -109),
        ((3, 14, 14, 24), (1, 0, 1, 0), -103),
        ((2, 5, 6, 4), (2, 1, 0, 3), 0), ((3, 4, 5, 1), (0, 2, 1, 0), 127),
        ((2, 5, 4, 5), (2, 1, 0, 3), -128),
        ((2, 3, 4, 128), (1, 1, 2, 2), 127), ((2, 3, 3, 7), (0, 0, 0, 0), 0)]


@pytest.mark.parametrize("shape,pads,fill", PADS)
def test_pad_plain_equals_jax(shape, pads, fill):
    pt, pb, pl, pr = pads
    x = _int8(np.random.default_rng(sum(shape) + fill + 128), shape)
    want = _cwhn(np.asarray(pk.pad_int8(jnp.asarray(_cwhn(x)),
                                        ((pl, pr), (pt, pb)), fill)))
    got = move.pad_int8(torch.from_numpy(x), pt, pb, pl, pr, fill)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        move.pad_int8_plain(torch.from_numpy(x), pt, pb, pl, pr,
                            fill).numpy(), want)


# --------------------------------------------------------------------------
# the plain versions against the per-op programs
# --------------------------------------------------------------------------
GRAPHS = {"corpus": lambda: load_tflite(CORPUS),
          "op surface": TOOL.surface_graph,
          "upsample": lambda: SMOKE._upsample_graph(TOOL)}
# the programs each graph gives the byte-move kernels
OWN = {"corpus": ["pad_int8", "pad_int8", "concat_channels", "pad_int8",
                  "concat_channels"],
       "op surface": ["pad_int8", "resize_nearest", "concat_channels",
                      "pad_int8"],
       "upsample": ["resize_nearest"]}


def _run_own(plan, x, check):
    """Run ``plan`` on ``x`` (CPU, plain); call ``check(stage, ins, out)``
    on each ``OWN_KERNELS`` program; -> their kernel names."""
    env = plan.run_stages(x)
    seen = []
    for st in plan.stages:
        if st.kernel in perop.OWN_KERNELS:
            seen.append(st.kernel)
            check(st, [env[i] for i in st.inputs], env[st.outputs[0]])
    return seen


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("bits", perop.BITS)
def test_wrappers_equal_the_perop_programs(graph, bits):
    """Each RESIZE, CONCATENATION and PAD program's output (the plain
    executor of its descriptors) equals the wrapper on the program's
    inputs, taken in the order and with the factors or pads
    ``stage.args`` holds; also on inputs one byte into their storage."""
    g = GRAPHS[graph]()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_int8(rng, (3,) + g.tensor(g.inputs[0]).shape[1:]))

    def check(st, ins, out):
        def wrapper(ins):
            if st.kernel == "resize_nearest":
                return move.resize_nearest(ins[0], *st.args)
            if st.kernel == "pad_int8":
                return move.pad_int8(ins[0], *st.args)
            return move.concat_channels([ins[j] for j in st.args])
        assert torch.equal(wrapper(ins), out), st.kernel
        buf = [torch.from_numpy(_int8(rng, 1 + t.numel())) for t in ins]
        off = [b[1:].view(t.shape) for b, t in zip(buf, ins)]
        want = torch.empty_like(out)
        perop.perop_plain(st, torch.from_numpy(st.consts), off + [want])
        assert torch.equal(wrapper(off), want), st.kernel
    plan = perop.PerOpPlan(g, bits)
    assert _run_own(plan, x, check) == OWN[graph]


def test_concat_of_a_repeated_input():
    """A CONCATENATION that reads one tensor twice has it once among the
    stage's inputs; ``stage.args`` names it twice, in channel order."""
    b = TOOL.GraphMaker(4)
    xa, xb = (b.tensor((1, 5, 6, c), scale=0.05, zp=-3) for c in (3, 5))
    b.op("CONCATENATION", [xa, xb, xa], b.tensor((1, 5, 6, 11), scale=0.05,
                                                 zp=-3),
         axis=3, activation="NONE")
    g = b.graph([xa, xb], [2])
    (st,) = perop.build_perop_plan(g)
    assert st.inputs == [xa, xb] and st.args == (0, 1, 0)
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(_int8(rng, (3,) + st.shapes[i]))
          for i in st.inputs]
    want = torch.empty((3, 5, 6, 11), dtype=torch.int8)
    perop.perop_plain(st, torch.from_numpy(st.consts), xs + [want])
    assert torch.equal(move.concat_channels([xs[j] for j in st.args]), want)
    assert torch.equal(perop.perop_op(st, torch.from_numpy(st.descs),
                                      torch.from_numpy(st.consts), xs)[0],
                       want)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("bits", perop.BITS)
def test_card_kernel_routes_exactly_concat_and_resize(graph, bits):
    """On the card the RESIZE programs go to ``resize_nearest``, the
    CONCATENATION programs (COPY rows into channel slices) to
    ``concat_channels`` and the PAD programs to ``pad_int8``; the ACT,
    standalone LEAKY and QUANTIZE programs to the table kernel, the ADD
    programs to the flat ADD kernel (``add_int8``, which takes no launch
    arguments) and every other program to the fused-stage kernel."""
    for st in perop.PerOpPlan(GRAPHS[graph](), bits).stages:
        codes = set(st.descs[:, F["code"]].tolist())
        if codes == {arena.RESIZE}:
            want = "resize_nearest"
        elif codes == {arena.PAD}:
            want = "pad_int8"
        elif codes == {arena.COPY}:
            want = "concat_channels"
        elif codes in ({arena.ACT}, {arena.LEAKY}, {arena.QUANTIZE}):
            want = "eltwise_lut"
        elif codes == {arena.ADD}:
            want = "add_int8"
        else:
            want = "fused_stage"
        assert perop.card_kernel(st) == want, st.kernel
        assert (st.kernel == want) == (want in perop.OWN_KERNELS
                                       or want == perop.ADD_KERNEL)
        assert bool(st.args) == (st.kernel in perop.OWN_KERNELS)


def test_launch_args_come_from_the_host_program():
    """A resize's factors, a concat's input order and a pad's (pt, pb, pl,
    pr, fill) are read from the program's host descriptors at plan time:
    the op surface's two PADs, ((1, 1), (1, 1)) with fill -3 and ((0, 1),
    (1, 0)) with fill 4, and the corpus's three, (1, 0, 1, 0) with the
    output zero-points."""
    g = TOOL.surface_graph()
    plan = perop.PerOpPlan(g)
    pads = [st.args for st in plan.stages if st.kernel == "pad_int8"]
    assert pads == [(1, 1, 1, 1, -3), (0, 1, 1, 0, 4)]
    for st, op in zip((st for st in plan.stages if st.kernel == "pad_int8"),
                      (op for op in g.ops if op.opname == "PAD")):
        p = g.tensor(op.inputs[1]).data
        d = st.descs[0]
        assert st.args == (p[1][0], p[1][1], p[2][0], p[2][1],
                           g.tensor(op.outputs[0]).qparams.zero_point)
        assert (d[F["pt"]], d[F["pl"]], d[F["fill"]]) == st.args[::2]
    corpus = load_tflite(CORPUS)
    assert [st.args for st in perop.PerOpPlan(corpus).stages
            if st.kernel == "pad_int8"] == [
        (1, 0, 1, 0, corpus.tensor(op.outputs[0]).qparams.zero_point)
        for op in corpus.ops if op.opname == "PAD"]
    for st in plan.stages:
        if st.kernel == "resize_nearest":
            assert st.args == (2, 2) == tuple(st.descs[0, [F["kh"], F["kw"]]])
        if st.kernel == "concat_channels":
            assert st.args == (0, 1, 2)
            assert st.descs[:, F["out_off"]].tolist() == [0, 8, 16]


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
def _x(*shape, dtype=torch.int8):
    return torch.zeros(shape, dtype=dtype)


REFUSED = {
    "resize float input": (lambda: move.resize_nearest(_x(2, 4, 4, 8).float(),
                                                       2, 2), "int8"),
    "resize strided input": (lambda: move.resize_nearest(
        _x(2, 4, 4, 8).permute(0, 3, 1, 2), 2, 2), "contiguous"),
    "resize 3-d input": (lambda: move.resize_nearest(_x(4, 4, 8), 2, 2),
                         r"\[N,H,W,C\]"),
    "resize factor 0": (lambda: move.resize_nearest(_x(2, 4, 4, 8), 0, 2),
                        "factors"),
    "resize factor 1.5": (lambda: move.resize_nearest(_x(2, 4, 4, 8), 1.5,
                                                      2), "factors"),
    "resize another device": (lambda: move.resize_nearest(
        _x(2, 4, 4, 8).to("meta"), 2, 2), "no resize kernel"),
    "resize out of another shape": (lambda: move.resize_nearest(
        _x(2, 4, 4, 8), 2, 2, out=_x(2, 8, 8, 4)), "out must be"),
    "concat no inputs": (lambda: move.concat_channels([]), "1 to 16"),
    "concat too many inputs": (lambda: move.concat_channels(
        [_x(1, 2, 2, 1)] * (move.MAX_INPUTS + 1)), "1 to 16"),
    "concat float input": (lambda: move.concat_channels(
        [_x(1, 2, 2, 3), _x(1, 2, 2, 3).float()]), "int8"),
    "concat strided input": (lambda: move.concat_channels(
        [_x(1, 2, 2, 3), _x(1, 3, 2, 2).permute(0, 2, 3, 1)]), "contiguous"),
    "concat other N": (lambda: move.concat_channels(
        [_x(1, 2, 2, 3), _x(2, 2, 2, 3)]), "N, H, W differ"),
    "concat other H, W": (lambda: move.concat_channels(
        [_x(1, 2, 2, 3), _x(1, 2, 3, 3)]), "N, H, W differ"),
    "concat two devices": (lambda: move.concat_channels(
        [_x(1, 2, 2, 3), _x(1, 2, 2, 3).to("meta")]), "on meta"),
    "concat another device": (lambda: move.concat_channels(
        [_x(1, 2, 2, 3).to("meta")]), "no concat kernel"),
    "concat out of another shape": (lambda: move.concat_channels(
        [_x(1, 2, 2, 3)] * 2, out=_x(1, 2, 2, 5)), "out must be"),
    "pad float input": (lambda: move.pad_int8(_x(2, 4, 4, 3).float(), 1, 0,
                                              1, 0, 0), "int8"),
    "pad strided input": (lambda: move.pad_int8(
        _x(2, 3, 4, 4).permute(0, 2, 3, 1), 1, 0, 1, 0, 0), "contiguous"),
    "pad 3-d input": (lambda: move.pad_int8(_x(4, 4, 3), 1, 0, 1, 0, 0),
                      r"\[N,H,W,C\]"),
    "pad negative pad": (lambda: move.pad_int8(_x(2, 4, 4, 3), 1, -1, 1, 0,
                                               0), "pads"),
    "pad pad 1.5": (lambda: move.pad_int8(_x(2, 4, 4, 3), 1, 0, 1.5, 0, 0),
                    "pads"),
    "pad fill 128": (lambda: move.pad_int8(_x(2, 4, 4, 3), 1, 0, 1, 0, 128),
                     "fill"),
    "pad fill -129": (lambda: move.pad_int8(_x(2, 4, 4, 3), 1, 0, 1, 0,
                                            -129), "fill"),
    "pad another device": (lambda: move.pad_int8(
        _x(2, 4, 4, 3).to("meta"), 1, 0, 1, 0, 0), "no pad kernel"),
    "pad out of another shape": (lambda: move.pad_int8(
        _x(2, 4, 4, 3), 1, 0, 1, 0, 0, out=_x(2, 5, 4, 3)), "out must be"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrappers_refuse(case):
    call, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_a_program_on_another_device_raises():
    """A RESIZE, CONCATENATION or PAD program on a device that is neither
    the CPU nor the card raises, as every per-op program does."""
    plan = perop.PerOpPlan(TOOL.surface_graph())
    for k, st in enumerate(plan.stages):
        if st.kernel in perop.OWN_KERNELS:
            xs = [_x(1, *st.shapes[i]).to("meta") for i in st.inputs]
            with pytest.raises(ValueError, match="no per-op kernel"):
                perop.perop_op(st, getattr(plan, f"descs{k}").to("meta"),
                               getattr(plan, f"consts{k}").to("meta"), xs)


# --------------------------------------------------------------------------
# serving on the CPU is unchanged
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", sorted(PEROP_BITS))
def test_cpu_engine_outputs_unchanged(mode):
    """``Int8Engine(surface, mode, device="cpu")`` and the corpus
    pipeline still give the golden keys, with no launch of any kernel."""
    gold = np.load(GOLDEN)
    bits = PEROP_BITS[mode]
    counters = (move.resize_nearest, move.concat_channels, move.pad_int8,
                eltwise.eltwise_lut, eltwise.add_flat, fused.fused_stage)
    for fn in counters:
        fn.launches = 0
    perop.reset_launches()
    ys = Int8Engine(TOOL.surface_graph(), mode, device="cpu")(
        torch.from_numpy(TOOL.surface_frames()))
    for k, y in enumerate(ys):
        np.testing.assert_array_equal(y.numpy(), gold[f"surface_{bits}{k}"])
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    pipe = load_pipeline(CORPUS, mode=mode, device="cpu")
    y = pipe.engine(pipe.preprocess(torch.from_numpy(gold["frames"])))
    np.testing.assert_array_equal(
        y.numpy(), gold["head_exact" if bits == "exact" else "head_fast"])
    assert all(fn.launches == 0 for fn in counters)
    assert perop.perop_op.launches == 0
