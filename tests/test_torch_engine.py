"""The port's engines against the JAX engine, bit for bit (tolerance 0):
the per-op ``exact``, ``fast`` and ``fast2`` modes on every tensor, and the
arena plans in ``exact`` and ``fast`` bits (the ``arena_exact`` and ``arena``
modes) on every stage output in 1 and >= 3 stages; the corpus graph and
fuzz seed 4."""

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
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "yoloface_corpus_int8.tflite")
SEED4_OPS = {"CONV_2D", "LEAKY_RELU", "PAD", "MAX_POOL_2D", "QUANTIZE",
             "CONCATENATION"}


@pytest.fixture(scope="module")
def corpus():
    return jax_load_tflite(CORPUS)


@pytest.fixture(scope="module")
def corpus_exact(corpus):
    """The JAX exact engine's every tensor on 4 frames, computed once."""
    x = _frames(0, 4, (56, 56, 3))
    return x, JaxEngine(corpus, "exact").run_with_intermediates(x)


def _frames(seed, n, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n,) + shape, dtype=np.int64)
    return x.astype(np.int8)


@pytest.mark.parametrize("mode,n_tensors", [("fast", 55), ("fast2", 38),
                                            ("exact", 55)])
def test_corpus_every_tensor_equals_jax(corpus, corpus_exact, mode,
                                        n_tensors):
    x = _frames(0, 4, (56, 56, 3))
    want = (corpus_exact[1] if mode == "exact"
            else JaxEngine(corpus, mode).run_with_intermediates(x))
    got = Int8Engine(graph_from_jax(corpus), mode,
                     device="cpu").run_with_intermediates(x)
    assert sorted(got) == sorted(want) and len(got) == n_tensors
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"t{k}")


@pytest.mark.parametrize("mode", ["fast", "fast2", "exact"])
def test_fuzz_seed4_equals_jax(mode):
    jg, rng = _int8_graph(4)
    # every op of seed 4 lies in the slice: the case cannot pass by skipping
    assert {op.opname for op in jg.ops} == SEED4_OPS
    x = rng.integers(-128, 128, (3, 14, 14, 3), dtype=np.int64).astype(np.int8)
    want = JaxEngine(jg, mode).run_with_intermediates(x)
    got = Int8Engine(graph_from_jax(jg), mode,
                     device="cpu").run_with_intermediates(x)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"t{k}")


def _stage_outputs(plan, x):
    return {k: v.numpy() for k, v in
            plan.run_stages(torch.from_numpy(x)).items()}


@pytest.mark.parametrize("budget,n_stages", [(arena.ARENA_BUDGET, 1),
                                             (18 * 1024, 4)])
@pytest.mark.parametrize("bits", ["exact", "fast"])
def test_corpus_arena_bits_equal_jax(corpus, corpus_exact, bits, budget,
                                     n_stages):
    """``ArenaPlan(bits=...)`` (the arena_exact / arena modes) against the
    JAX engine of the same bits on every stage output."""
    x, want = corpus_exact
    if bits == "fast":
        want = JaxEngine(corpus, "fast").run_with_intermediates(x)
    plan = arena.ArenaPlan(graph_from_jax(corpus), budget, bits=bits)
    assert len(plan.stages) == n_stages
    epis = np.concatenate([st.descs[:, arena.F["epi"]] for st in plan.stages])
    fused = arena.EPI_LEAKY_EXACT if bits == "exact" else arena.EPI_LEAKY_V1
    assert (epis == fused).sum() == 17            # every conv+leaky pair
    got = _stage_outputs(plan, x)
    assert len(got) == 1 + sum(len(st.outputs) for st in plan.stages)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"t{k}")


@pytest.mark.parametrize("budget", [arena.ARENA_BUDGET, 2400])
@pytest.mark.parametrize("bits", ["exact", "fast"])
def test_fuzz_seed4_arena_bits_equal_jax(bits, budget):
    jg, rng = _int8_graph(4)
    x = rng.integers(-128, 128, (3, 14, 14, 3), dtype=np.int64).astype(np.int8)
    want = JaxEngine(jg, bits).run_with_intermediates(x)
    plan = arena.ArenaPlan(graph_from_jax(jg), budget, bits=bits)
    assert len(plan.stages) == (2 if budget == 2400 else 1)
    for k, v in _stage_outputs(plan, x).items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"t{k}")


@pytest.mark.parametrize("mode,jax_mode", [("arena_exact", "exact"),
                                           ("arena", "fast")])
def test_arena_modes_serve_like_jax(corpus, mode, jax_mode):
    x = _frames(5, 5, (56, 56, 3))
    want = np.asarray(JaxEngine(corpus, jax_mode)(x))
    got = Int8Engine(graph_from_jax(corpus), mode,
                     device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_exact_left_shift_out_of_int32_raises():
    """A requant whose left shift would take |x| out of int32 is refused at
    plan time, never wrapped: a QUANTIZE with a ratio of 2**24."""
    i8 = np.dtype(np.int8)
    tensors = [TensorDef(0, "in", (1, 4, 4, 2), i8, QParams((1.0,), (0,))),
               TensorDef(1, "q", (1, 4, 4, 2), i8,
                         QParams((2.0 ** -24,), (0,)))]
    g = GraphDef(tensors, [OpDef(0, "QUANTIZE", [0], [1], {})], [0], [1])
    arena.build_arena_plan(g, bits="fast")
    with pytest.raises(NotImplementedError, match="int32"):
        arena.build_arena_plan(g, bits="exact")


@pytest.mark.parametrize("n", [1, 7])
def test_ragged_batches(corpus, n):
    x = _frames(n, n, (56, 56, 3))
    want = np.asarray(JaxEngine(corpus, "fast2")(x))
    got = Int8Engine(graph_from_jax(corpus), "fast2",
                     device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def _tiny_graph(opname):
    q = QParams((0.05,), (3,))
    tensors = [TensorDef(0, "in", (1, 4, 4, 2), np.dtype(np.int8), q),
               TensorDef(1, "out", (1, 4, 4, 2), np.dtype(np.int8), q)]
    return GraphDef(tensors, [OpDef(0, opname, [0], [1], {})], [0], [1])


@pytest.mark.parametrize("mode", ["exact", "fast", "fast2", "arena_exact",
                                  "arena", "arena2", "tiled_exact", "tiled",
                                  "tiled2", "fused_exact", "fused"])
def test_unknown_op_raises(mode):
    """An op no mode of the port lowers yet (ROADMAP A8) is refused by
    name, in every mode."""
    with pytest.raises(NotImplementedError, match="AVERAGE_POOL_2D"):
        Int8Engine(_tiny_graph("AVERAGE_POOL_2D"), mode, device="cpu")


def test_default_device_is_the_card(corpus):
    """``Int8Engine`` and ``load_pipeline`` run on the card unless the
    caller names the CPU: without a card the default raises, it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there "
                    "(tests/test_torch_gpu.py)")
    with pytest.raises(RuntimeError, match="CUDA"):
        Int8Engine(graph_from_jax(corpus))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pipeline(CORPUS)


def test_bad_mode_and_input_rejected(corpus):
    g = graph_from_jax(corpus)
    with pytest.raises(ValueError, match="mode"):
        Int8Engine(g, "pallas_mxu2", device="cpu")
    eng = Int8Engine(g, "fast2", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        eng(torch.zeros((1, 56, 56, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="expected input"):
        eng(torch.zeros((1, 28, 28, 3), dtype=torch.int8))
