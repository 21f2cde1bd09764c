"""The arena planner and its plain executor (the CUDA stage kernel's plain
version) against the JAX package, bit for bit (tolerance 0) on every stage
output: the corpus in one stage and a >= 3-stage split, concat aliasing;
fuzz seeds 0-7, the v3-tiny FPN, the op-surface graph and the eltwise
chain in ``arena2`` / ``arena`` / ``arena_exact`` against JAX ``fast2`` /
``fast`` / ``exact`` (and, under ``slow``, the v3-tiny FPN against
``pallas_mxu2`` / ``pallas_mxu`` / ``pallas_mxu_exact``, which take 13-21 s
each in interpret mode); the .tflite test graphs in every kernel mode
against their golden keys."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import test_darknet_ptq as ptq
from test_tiled_fuzz import _int8_graph
from test_torch_fused import _chain_graph
from yoloface_tpu.io.darknet_cfg import DarknetNet, template_from_darknet
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.quantize.calibrate import calibrate_from_weights
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.graph import ir
from yoloface_tpu_torch.graph.ir import GraphDef, OpDef, QParams, TensorDef
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena
from yoloface_tpu_torch.runtime.engine import (ARENA_BITS, KERNEL_MODES,
                                               Int8Engine)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
SMALL = 18 * 1024          # forces the corpus graph into 4 stages
JAX_MXU = {"arena2": "pallas_mxu2", "arena": "pallas_mxu",
           "arena_exact": "pallas_mxu_exact"}


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _golden_tool()         # numpy at import; jax only inside functions


class OneOpAStage(arena.ArenaPlan):
    """The arena plan at one lowered op a stage."""

    def _plan(self, graph, budget, bits):
        lops, alias = arena.lower_arena_ops(graph, bits)
        return [arena.plan_stage(graph, lops, k, k + 1, alias)
                for k in range(len(lops))]


def _assert_equal(got, want):
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=f"t{k}")


@pytest.fixture(scope="module")
def corpus():
    g = jax_load_tflite(CORPUS)
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, (3, 56, 56, 3), dtype=np.int64).astype(np.int8)
    return g, x, JaxEngine(g, "fast2").run_with_intermediates(x)


def _codes(stage):
    return stage.descs[:, arena.F["code"]].tolist()


def _run_plan(plan, x):
    """Every stage input and output of ``plan`` on ``x``, as numpy."""
    return {k: v.numpy() for k, v in
            plan.run_stages(torch.from_numpy(x)).items()}


@pytest.mark.parametrize("budget,n_stages", [(arena.ARENA_BUDGET, 1),
                                             (SMALL, 4)])
def test_corpus_stage_outputs_equal_fast2(corpus, budget, n_stages):
    jg, x, want = corpus
    plan = arena.ArenaPlan(graph_from_jax(jg), budget)
    stages = plan.stages
    assert len(stages) == n_stages
    assert all(st.arena_bytes <= budget for st in stages)
    got = _run_plan(plan, x)
    assert set(got) == {jg.inputs[0]} | {o for st in stages
                                         for o in st.outputs}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"t{k}")


def test_corpus_single_stage_plan(corpus):
    """Both concats alias (no COPY into them): the only COPYs load the
    input and store the output; liveness reuses the arena."""
    jg, _, want = corpus
    (st,) = arena.build_arena_plan(graph_from_jax(jg))
    codes = _codes(st)
    assert codes.count(arena.COPY) == 2
    assert codes[0] == arena.COPY and codes[-1] == arena.COPY
    # 17 CONV (stem + 16 1x1), 7 DW, 2 MAXPOOL, 3 ADD, 3 QUANTIZE
    assert [codes.count(c) for c in (arena.CONV, arena.DW, arena.MAXPOOL,
                                     arena.ADD, arena.QUANTIZE)] == \
        [17, 7, 2, 3, 3]
    total = sum(v[0].size for k, v in want.items() if k != jg.inputs[0])
    assert st.arena_bytes < total // 4
    epi = st.descs[:, arena.F["epi"]]
    assert (epi == arena.EPI_LEAKY_V2).sum() == 17        # fused conv+leaky


def test_split_crosses_stages_through_globals(corpus):
    jg, _, _ = corpus
    stages = arena.build_arena_plan(graph_from_jax(jg), SMALL)
    produced = set()
    for st in stages:
        assert set(st.inputs) <= produced | {jg.inputs[0]}
        produced |= set(st.outputs)
    assert jg.outputs[0] in stages[-1].outputs


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("mode", ["arena2", "arena", "arena_exact"])
def test_fuzz_stage_outputs_equal_jax(seed, mode):
    """Fuzz seeds 0-7 (standalone LEAKY, RELU, RESIZE, SAME and stride-1
    pools, absorbed PADs, concats, ADDs): every stage output of the arena
    mode equals the JAX engine of the same bits, in one stage through the
    engine and at one op a stage (every op's output through device
    memory).  Seed 4's whole-frame concat of two QUANTIZEs aliases."""
    jg, rng = _int8_graph(seed)
    x = rng.integers(-128, 128, (3, 14, 14, 3), dtype=np.int64).astype(np.int8)
    want = JaxEngine(jg, ARENA_BITS[mode]).run_with_intermediates(x)
    g = graph_from_jax(jg)
    eng = Int8Engine(g, mode, device="cpu")
    assert len(eng.arena.stages) == 1
    if seed == 4:
        assert _codes(eng.arena.stages[0]).count(arena.COPY) == 2
    _assert_equal(eng.run_with_intermediates(x), want)
    plan = OneOpAStage(g, bits=ARENA_BITS[mode])
    assert len(plan.stages) >= 5
    _assert_equal(_run_plan(plan, x), want)


@pytest.mark.parametrize("n", [1, 7])
def test_ragged_batches(corpus, n):
    jg, _, _ = corpus
    rng = np.random.default_rng(n)
    x = rng.integers(-128, 128, (n, 56, 56, 3), dtype=np.int64).astype(np.int8)
    want = np.asarray(JaxEngine(jg, "fast2")(x))
    got = Int8Engine(graph_from_jax(jg), "arena2",
                     device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_budget_below_one_op_raises(corpus):
    with pytest.raises(NotImplementedError, match="budget"):
        arena.build_arena_plan(graph_from_jax(corpus[0]), 4096)


def test_pad_into_non_window_op_raises():
    q = QParams((0.05,), (3,))
    i8 = np.dtype(np.int8)
    tensors = [TensorDef(0, "in", (1, 4, 4, 2), i8, q),
               TensorDef(1, "pads", (4, 2), np.dtype(np.int32), None,
                         np.array([[0, 0], [1, 0], [1, 0], [0, 0]], np.int32)),
               TensorDef(2, "padded", (1, 5, 5, 2), i8, q),
               TensorDef(3, "q", (1, 5, 5, 2), i8, QParams((0.1,), (0,)))]
    ops = [OpDef(0, "PAD", [0, 1], [2], {}),
           OpDef(1, "QUANTIZE", [2], [3], {})]
    with pytest.raises(NotImplementedError, match="PAD"):
        arena.build_arena_plan(GraphDef(tensors, ops, [0], [3]))


@pytest.fixture(scope="module")
def v3tiny():
    """tests/test_darknet_ptq.py's two-headed v3-tiny FPN, int8."""
    net = DarknetNet(ptq.V3_TINY_CFG)
    template, weights = template_from_darknet(net, ptq._random_params(net))
    rep = np.random.default_rng(5).uniform(0, 1, (16, 32, 32, 3))
    return calibrate_from_weights(weights, rep.astype(np.float32), template)


def _v3tiny_frames():
    return np.random.default_rng(11).integers(
        -128, 128, (2, 32, 32, 3), dtype=np.int64).astype(np.int8)


@pytest.mark.parametrize("mode", list(ARENA_BITS))
def test_v3tiny_heads_equal_jax(v3tiny, mode):
    """The two-headed FPN (a RESIZE into a concat, two outputs in order):
    every stage output equals the JAX engine of the mode's bits."""
    x = _v3tiny_frames()
    want = JaxEngine(v3tiny, ARENA_BITS[mode]).run_with_intermediates(x)
    eng = Int8Engine(graph_from_jax(v3tiny), mode, device="cpu")
    assert arena.RESIZE in _codes(eng.arena.stages[0])
    _assert_equal(eng.run_with_intermediates(x), want)
    got = eng(torch.from_numpy(x))
    assert len(got) == 2
    for y, o in zip(got, v3tiny.outputs):
        np.testing.assert_array_equal(y.numpy(), want[o])


@pytest.mark.slow
@pytest.mark.parametrize("mode", list(ARENA_BITS))
def test_v3tiny_heads_equal_pallas_mxu(v3tiny, mode):
    """Both heads equal JAX ``pallas_mxu2`` / ``pallas_mxu`` /
    ``pallas_mxu_exact`` (tests/test_darknet_ptq.py:201) in interpret
    mode."""
    x = _v3tiny_frames()
    want = JaxEngine(v3tiny, JAX_MXU[mode])(x)
    got = Int8Engine(graph_from_jax(v3tiny), mode,
                     device="cpu")(torch.from_numpy(x))
    for y, w in zip(got, want):
        np.testing.assert_array_equal(y.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", list(ARENA_BITS))
def test_op_surface_equals_jax_and_golden(mode):
    """The op-surface graph: a standalone LEAKY, RELU, RELU6, LOGISTIC and
    RESIZE, and a PAD that a SAME max-pool would pad again, kept as an op.
    Every stage output equals the JAX engine of the mode's bits, in one
    stage and split at a small budget, and the outputs equal the golden
    keys."""
    g, x = TOOL.surface_graph(), TOOL.surface_frames()
    bits = ARENA_BITS[mode]
    want = JaxEngine(TOOL.jax_graph(g), bits).run_with_intermediates(x)
    gold = np.load(GOLDEN)
    eng = Int8Engine(g, mode, device="cpu")
    assert set(_codes(eng.arena.stages[0])) == {
        arena.COPY, arena.CONV, arena.DW, arena.MAXPOOL, arena.ADD,
        arena.QUANTIZE, arena.PAD, arena.LEAKY, arena.ACT, arena.RESIZE}
    _assert_equal(eng.run_with_intermediates(x), want)
    for k, y in enumerate(eng(torch.from_numpy(x))):
        np.testing.assert_array_equal(y.numpy(), gold[f"surface_{bits}{k}"])
    plan = OneOpAStage(g, bits=bits)
    assert len(plan.stages) == 14
    _assert_equal(_run_plan(plan, x), want)


@pytest.mark.parametrize("mode", list(ARENA_BITS))
def test_eltwise_activation_ops(mode):
    """The port's counterpart of tests/test_tiled_fuzz.py::
    test_eltwise_activation_ops: RELU, RELU6, QUANTIZE and LOGISTIC as
    arena ops equal the JAX engine of the mode's bits on every tensor, one
    op a stage too."""
    from yoloface_tpu.graph import ir as jir
    x = np.random.default_rng(7).integers(-128, 128, (2, 10, 10, 5),
                                          dtype=np.int64).astype(np.int8)
    want = JaxEngine(_chain_graph(jir), ARENA_BITS[mode]
                     ).run_with_intermediates(x)
    assert (want[4] != x).any()                    # the chain acts
    g = _chain_graph(ir)
    for plan in (arena.ArenaPlan(g, bits=ARENA_BITS[mode]),
                 OneOpAStage(g, bits=ARENA_BITS[mode])):
        _assert_equal(_run_plan(plan, x), want)


@pytest.mark.parametrize("name", TOOL.TFLITE_GRAPHS)
def test_tflite_graph_every_kernel_mode_equals_golden(name):
    """The .tflite test graphs as the port's importer reads them: every
    kernel mode's outputs equal the golden keys of its bits (the JAX
    engines' outputs on the same file)."""
    g = load_tflite(TOOL.tflite_path(name))
    x = TOOL.tflite_frames(name)
    gold = np.load(GOLDEN)
    assert str(gold[f"tflite_{name}_frames_sha256"]) == TOOL.sha256(x)
    for mode, bits in KERNEL_MODES.items():
        ys = Int8Engine(g, mode, device="cpu")(x)
        for k, y in enumerate(ys if isinstance(ys, tuple) else (ys,)):
            np.testing.assert_array_equal(
                y.numpy(), gold[TOOL.tflite_key(name, bits, k)],
                err_msg=f"{mode} output {k}")
