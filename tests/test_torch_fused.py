"""The fused-stage family in the port (``kernels/fused.py``, engine modes
``fused`` and ``fused_exact``) and the op surface it brings (RELU, RELU6,
LOGISTIC, RESIZE_NEAREST_NEIGHBOR, standalone LEAKY_RELU and PAD, N-ary
concat) against the JAX package on the CPU.

Tolerance 0 on every int8 tensor.  The JAX side runs as its own tests run
it: ``pallas_fused`` / ``pallas_fused_exact`` in interpret mode, and the XLA
twins ``fast`` / ``exact``.  On the corpus graph at ``FUSED_BUDGET`` the
stage outputs are JAX's, tensor for tensor; at other budgets every stage
output equals the twin's tensor.  The graphs: the corpus, fuzz seeds 0, 2
and 5 of ``tests/test_tiled_fuzz.py`` (RELU in each; seed 5 samples the
upsample, which seed 2 does not), the two-headed v3-tiny FPN of
``tests/test_darknet_ptq.py``, the eltwise chain of
``tests/test_tiled_fuzz.py`` and the op-surface graph of
``tools/make_torch_port_golden.py``."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import test_darknet_ptq as ptq
from test_tiled_fuzz import _int8_graph
from yoloface_tpu.graph import ir as jir
from yoloface_tpu.io.darknet_cfg import DarknetNet, template_from_darknet
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.ops import int8_ref as jax_ops
from yoloface_tpu.quantize.calibrate import calibrate_from_weights
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.graph import ir
from yoloface_tpu_torch.graph.retarget import retarget_spatial
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena, fused
from yoloface_tpu_torch.ops import int8_ref
from yoloface_tpu_torch.pipeline import head as thead
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime.engine import FUSED_BITS, Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
JAX_FUSED = {"fast": "pallas_fused", "exact": "pallas_fused_exact"}
MODE = {bits: mode for mode, bits in FUSED_BITS.items()}


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(seed, n, hw):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (n, hw, hw, 3), dtype=np.int64
                        ).astype(np.int8)


def _stage_outputs(plan, x):
    return {k: v.numpy() for k, v in
            plan.run_stages(torch.from_numpy(x)).items()}


def _assert_equal(got, want):
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=f"t{k}")


@pytest.fixture(scope="module")
def corpus():
    """The JAX corpus graph, 2 frames, and the JAX twins' every tensor."""
    jg = jax_load_tflite(CORPUS)
    x = _frames(0, 2, 56)
    twins = {b: JaxEngine(jg, b).run_with_intermediates(x)
             for b in fused.BITS}
    return jg, x, twins


@pytest.mark.parametrize("bits", fused.BITS)
def test_corpus_stages_equal_pallas_fused(corpus, bits):
    """At ``FUSED_BUDGET`` the plan cuts JAX's 3 stages: its stage outputs
    are the tensors JAX ``pallas_fused[_exact]`` returns, and equal them
    (and the twin's)."""
    jg, x, twins = corpus
    want = JaxEngine(jg, JAX_FUSED[bits]).run_with_intermediates(x)
    plan = fused.FusedPlan(graph_from_jax(jg), bits=bits)
    assert len(plan.stages) == 3
    got = _stage_outputs(plan, x)
    assert sorted(got) == sorted(want) == [0, 58, 62, 64, 95, 100]
    _assert_equal(got, want)
    _assert_equal(got, twins[bits])
    epis = np.concatenate([st.descs[:, arena.F["epi"]] for st in plan.stages])
    fused_epi = (arena.EPI_LEAKY_EXACT if bits == "exact"
                 else arena.EPI_LEAKY_V1)
    assert (epis == fused_epi).sum() == 17            # every conv+leaky pair


@pytest.mark.parametrize("budget,n_stages", [(10 ** 9, 1), (1, 34)])
@pytest.mark.parametrize("bits", fused.BITS)
def test_corpus_other_budgets_equal_jax(corpus, bits, budget, n_stages):
    """One stage (the whole net in one block's shared memory) and one op a
    stage: every stage output equals the JAX twin's tensor."""
    jg, x, twins = corpus
    plan = fused.FusedPlan(graph_from_jax(jg), budget, bits)
    assert len(plan.stages) == n_stages
    assert max(st.smem_bytes for st in plan.stages) <= fused.SMEM_BYTES
    got = _stage_outputs(plan, x)
    assert len(got) == 1 + sum(len(st.outputs) for st in plan.stages)
    _assert_equal(got, twins[bits])


@pytest.mark.parametrize("seed", [0, 2, 5])
@pytest.mark.parametrize("bits", fused.BITS)
def test_fuzz_fused_equals_jax(seed, bits):
    """Fuzz seeds 0, 2 and 5 (RELU in each; absorbed PADs and SAME pools;
    seed 2 a concat, seed 5 a RESIZE): the fused mode equals JAX
    ``pallas_fused[_exact]`` and, on every stage output, the twin."""
    jg, rng = _int8_graph(seed)
    assert "RELU" in {op.opname for op in jg.ops}
    x = rng.integers(-128, 128, (2, 14, 14, 3), dtype=np.int64
                     ).astype(np.int8)
    want = np.asarray(JaxEngine(jg, JAX_FUSED[bits])(x))
    eng = Int8Engine(graph_from_jax(jg), MODE[bits], device="cpu")
    np.testing.assert_array_equal(eng(torch.from_numpy(x)).numpy(), want)
    _assert_equal(eng.run_with_intermediates(x),
                  JaxEngine(jg, bits).run_with_intermediates(x))


@pytest.mark.parametrize("seed", [0, 2, 5])
@pytest.mark.parametrize("mode", ["exact", "fast", "fast2"])
def test_fuzz_base_modes_equal_jax(seed, mode):
    """The per-op modes lower RELU (and the rest of the seeds' ops) as the
    JAX engine does: every tensor equal."""
    jg, rng = _int8_graph(seed)
    x = rng.integers(-128, 128, (3, 14, 14, 3), dtype=np.int64
                     ).astype(np.int8)
    want = JaxEngine(jg, mode).run_with_intermediates(x)
    got = Int8Engine(graph_from_jax(jg), mode,
                     device="cpu").run_with_intermediates(x)
    assert sorted(got) == sorted(want)
    _assert_equal(got, want)


@pytest.fixture(scope="module")
def v3tiny():
    """tests/test_darknet_ptq.py's two-headed v3-tiny FPN, int8."""
    net = DarknetNet(ptq.V3_TINY_CFG)
    template, weights = template_from_darknet(net, ptq._random_params(net))
    rep = np.random.default_rng(5).uniform(0, 1, (16, 32, 32, 3))
    return calibrate_from_weights(weights, rep.astype(np.float32), template)


@pytest.mark.parametrize("bits", fused.BITS)
def test_v3tiny_both_heads_equal_jax(v3tiny, bits):
    """RESIZE, a 1-input concat, a leaky read twice, two graph outputs in
    order: both heads equal JAX ``pallas_fused[_exact]`` and the twin."""
    x = np.random.default_rng(11).integers(
        -128, 128, (2, 32, 32, 3), dtype=np.int64).astype(np.int8)
    want = [np.asarray(y) for y in JaxEngine(v3tiny, JAX_FUSED[bits])(x)]
    twin = [np.asarray(y) for y in JaxEngine(v3tiny, bits)(x)]
    got = Int8Engine(graph_from_jax(v3tiny), MODE[bits],
                     device="cpu")(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w, t in zip(got, want, twin):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), t)


def _chain_graph(m):
    """tests/test_tiled_fuzz.py's RELU -> RELU6 -> QUANTIZE -> LOGISTIC
    chain, in the IR module ``m`` (the JAX package's or the port's)."""
    q_in = m.QParams((0.043,), (-7,))
    i8 = np.dtype(np.int8)
    tensors = [m.TensorDef(0, "in", (1, 10, 10, 5), i8, q_in),
               m.TensorDef(1, "r", (1, 10, 10, 5), i8, q_in),
               m.TensorDef(2, "r6", (1, 10, 10, 5), i8, q_in),
               m.TensorDef(3, "q", (1, 10, 10, 5), i8,
                           m.QParams((0.021,), (4,))),
               m.TensorDef(4, "sig", (1, 10, 10, 5), i8,
                           m.QParams((1.0 / 256.0,), (-128,)))]
    ops = [m.OpDef(0, "RELU", [0], [1], {}),
           m.OpDef(1, "RELU6", [1], [2], {}),
           m.OpDef(2, "QUANTIZE", [2], [3], {}),
           m.OpDef(3, "LOGISTIC", [3], [4], {})]
    return m.GraphDef(tensors, ops, [0], [4])


@pytest.mark.parametrize("mode,twin", [
    ("exact", "exact"), ("fast", "fast"), ("fast2", "fast2"),
    ("fused", "pallas_fused"), ("fused_exact", "pallas_fused_exact")])
def test_eltwise_chain_equals_jax(mode, twin):
    x = np.random.default_rng(7).integers(-128, 128, (2, 10, 10, 5),
                                          dtype=np.int64).astype(np.int8)
    want = JaxEngine(_chain_graph(jir), twin).run_with_intermediates(x)
    got = Int8Engine(_chain_graph(ir), mode,
                     device="cpu").run_with_intermediates(x)
    assert (got[4] != x).any()                 # the chain acts
    _assert_equal(got, want)


# every LOGISTIC input quantization of the graphs above (the eltwise
# chain's two, the op-surface graph's) and the head's, where XLA's and
# torch's float32 exp are known to differ by an ulp on some inputs
LOGISTIC_QS = [(0.021, 4), (0.07, -20), (0.14218327403068542, -15),
               (0.043, -7)]


@pytest.mark.parametrize("scale,zp", LOGISTIC_QS)
def test_logistic_every_input_equals_jax(scale, zp):
    """All 256 int8 inputs: torch's CPU ``exp`` and XLA's differ by an ulp
    on some of them in float32, and no int8 output flips."""
    x = np.arange(-128, 128, dtype=np.int8).reshape(1, 1, 16, 16)
    want = np.asarray(jax_ops.logistic_int8(x, input_scale=scale,
                                            input_zp=zp))
    got = int8_ref.logistic_int8(torch.from_numpy(x), input_scale=scale,
                                 input_zp=zp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def surface():
    tool = _golden_tool()
    return tool, tool.surface_graph(), tool.surface_frames()


@pytest.mark.parametrize("bits", fused.BITS)
def test_op_surface_equals_jax_and_golden(surface, bits):
    """Every op B7 lowers, in one graph: the fused mode equals JAX
    ``pallas_fused[_exact]`` and the golden keys; the base mode of the same
    bits, and the plan at one op a stage, equal the JAX twin on every
    tensor."""
    tool, g, x = surface
    jg = tool.jax_graph(g)
    gold = np.load(GOLDEN)
    assert str(gold["surface_frames_sha256"]) == tool.sha256(x)
    want = [np.asarray(y) for y in JaxEngine(jg, JAX_FUSED[bits])(x)]
    eng = Int8Engine(g, MODE[bits], device="cpu")
    (st,) = eng.arena.stages
    codes = set(st.descs[:, arena.F["code"]].tolist())
    assert codes == {arena.COPY, arena.CONV, arena.DW, arena.MAXPOOL,
                     arena.ADD, arena.QUANTIZE, arena.PAD, arena.LEAKY,
                     arena.ACT, arena.RESIZE}
    got = eng(torch.from_numpy(x))
    for k, (y, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(y.numpy(), w)
        np.testing.assert_array_equal(y.numpy(), gold[f"surface_{bits}{k}"])
    twin = JaxEngine(jg, bits).run_with_intermediates(x)
    _assert_equal(Int8Engine(g, bits, device="cpu").run_with_intermediates(x),
                  twin)
    one_op = fused.FusedPlan(g, 1, bits)
    assert len(one_op.stages) == 14
    _assert_equal(_stage_outputs(one_op, x), twin)


def test_golden_surface_equals_recomputed_jax_side(surface):
    tool = surface[0]
    gold = np.load(GOLDEN)
    want = tool.jax_outputs_surface()
    assert sorted(want) == sorted(tool.KEYS_SURFACE)
    for k, v in want.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)


def _mutated(change):
    """The op-surface graph with one thing JAX's fused lowering gets wrong."""
    g = _golden_tool().surface_graph()
    change(g)
    return g


def _set(op, **attrs):
    return lambda g: g.ops[op].attrs.update(attrs)


def _weights(idx, shape):
    def change(g):
        g.tensors[idx].data = np.ones(shape, np.int8)
    return change


def _one_by_one_through_pad(g):
    _set(1, stride_h=1, stride_w=1)(g)
    _weights(4, (8, 1, 1, 3))(g)


REFUSALS = {
    "1x1 stride 2": (_set(4, stride_h=2, stride_w=2), "1x1 with stride 2"),
    "1x1 through a PAD": (_one_by_one_through_pad, "1x1 through a PAD"),
    "concat off channels": (_set(12, axis=1), "off the channel axis"),
    "conv stride 2x1": (_set(1, stride_w=1), "stride 2x1"),
    "pool stride 2x1": (_set(14, stride_w=1), "stride 2x1"),
    "depthwise 5x5": (_weights(8, (1, 5, 5, 8)), "depthwise convs are 3x3"),
    "conv 3x1": (_weights(4, (8, 3, 1, 3)), "3x1 kernel"),
    "dilation": (_set(1, dilation_h=2, dilation_w=2), "dilation"),
    "fused activation": (_set(1, activation="RELU"), "fused activation"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_fused_plan_refuses(case):
    change, match = REFUSALS[case]
    for bits in fused.BITS:
        with pytest.raises(NotImplementedError, match=match):
            fused.build_fused_plan(_mutated(change), bits=bits)


def test_op_beyond_shared_memory_names_tiled_modes():
    """An op whose values alone pass one block's shared memory (the 448
    stem) is refused, naming the modes that cut it into row strips."""
    g = retarget_spatial(load_tflite(CORPUS), 8)
    with pytest.raises(NotImplementedError, match="tiled2"):
        fused.build_fused_plan(g)


@pytest.mark.parametrize("mode,key", [("fused", "head_fast"),
                                      ("fused_exact", "head_exact")])
def test_serving_on_golden_frames(mode, key):
    """``load_pipeline(corpus, mode, device="cpu")`` (the preprocess, stage
    and head kernels' plain versions) gives the golden int8 head; in exact
    bits the golden detections too."""
    gold = dict(np.load(GOLDEN))
    pipe = load_pipeline(CORPUS, mode=mode, device="cpu")
    head = pipe.engine(pipe.preprocess(gold["frames"]))
    np.testing.assert_array_equal(head.numpy(), gold[key])
    got = pipe.detect_rgb565(gold["frames"])
    if mode == "fused_exact":
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


def test_stage_wrapper_routes_by_device(corpus):
    """CPU tensors take the plain version (no launch counted); a tensor on
    another device raises."""
    plan = fused.FusedPlan(graph_from_jax(corpus[0]))
    st = plan.stages[0]
    x = torch.from_numpy(_frames(3, 2, 56))
    before = fused.fused_stage.launches
    outs = fused.fused_stage(st, plan.descs0, plan.consts0, [x])
    assert fused.fused_stage.launches == before
    ref = [torch.empty_like(o) for o in outs]
    fused.fused_stage_plain(st, plan.consts0, [x] + ref)
    assert all(torch.equal(a, b) for a, b in zip(outs, ref))
    with pytest.raises(ValueError, match="no fused-stage kernel"):
        fused.fused_stage(st, plan.descs0.to("meta"),
                          plan.consts0.to("meta"), [x.to("meta")])
