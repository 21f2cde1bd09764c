"""The arena planner and its plain executor (the CUDA stage kernel's plain
version) against JAX ``fast2``, bit for bit (tolerance 0) on every stage
output: one stage and a >= 3-stage split, concat aliasing, fuzz seed 4."""

import os

import numpy as np
import pytest
import torch

from test_tiled_fuzz import _int8_graph
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.graph.ir import GraphDef, OpDef, QParams, TensorDef
from yoloface_tpu_torch.kernels import arena
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "yoloface_corpus_int8.tflite")
SMALL = 18 * 1024          # forces the corpus graph into 4 stages


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


@pytest.mark.parametrize("budget", [arena.ARENA_BUDGET, 2400])
def test_fuzz_seed4_stage_outputs_equal_fast2(budget):
    jg, rng = _int8_graph(4)
    x = rng.integers(-128, 128, (3, 14, 14, 3), dtype=np.int64).astype(np.int8)
    want = JaxEngine(jg, "fast2").run_with_intermediates(x)
    plan = arena.ArenaPlan(graph_from_jax(jg), budget)
    if budget == 2400:
        assert len(plan.stages) >= 2
    else:    # the concat of the two QUANTIZEs aliases: no COPY into it
        assert _codes(plan.stages[0]).count(arena.COPY) == 2
    for k, v in _run_plan(plan, x).items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"t{k}")


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
