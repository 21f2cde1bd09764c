"""The 448 family in the port: ``graph/retarget.py`` and the tiled plan
(``kernels/tiled.py``) with its plain executor, the CUDA section kernel's
plain version, against the JAX package on the CPU.

Tolerance 0 throughout: every section input and output of the ``tiled2``,
``tiled`` and ``tiled_exact`` modes equals the JAX ``fast2``, ``fast`` and
``exact`` engines' tensor, at retarget factor 2 (the default budget, where
the plan is the arena plan, and a small one that cuts the net into seven
strip programs) and at full width, factor 8 (448x448).  ``tiled2`` also
equals the JAX ``pallas_tiled2`` mode (the Pallas section kernel in
interpret mode).  The golden 448 keys of ``tests/data/torch_port_frames.npz``
are pinned by sha256 and recomputed."""

import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from yoloface_tpu.graph import ir as jir
from yoloface_tpu.graph.retarget import retarget_spatial as jax_retarget
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.convert import graph_from_jax
from yoloface_tpu_torch.graph import ir
from yoloface_tpu_torch.graph.retarget import retarget_spatial
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena, tiled
from yoloface_tpu_torch.runtime.engine import TILED_BITS, Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
SMALL = 16 * 1024          # cuts the x2 net into 7 sections of 2-28 strips
# sha256 of the golden 448 keys as first written
DIGESTS448 = {
    "head448":
        "f92af54958155da95ba0c54cbde75e75de4e908ffb556e39412930fdfbf9a4ae",
    "head448_exact":
        "15788b7804ea3ff90eb79746e7fc5be11835d2bf52e56cb353da8ad81f932203",
}
FRAMES448_SHA256 = \
    "79599cea99766f6cfa9ed9b55e91e42eb61c3265d6d3cfbf28d3d33b19ae7dda"


@pytest.fixture(scope="module")
def jax_corpus():
    return jax_load_tflite(CORPUS)


def _frames(seed, n, hw):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (n, hw, hw, 3), dtype=np.int64)
    return x.astype(np.int8)


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _resize_graph(m):
    """in [1,4,4,2] -> RESIZE_NEAREST_NEIGHBOR (size const [8,8]), in the
    IR module ``m`` (the JAX package's or the port's)."""
    q = m.QParams((0.05,), (3,))
    i8 = np.dtype(np.int8)
    tensors = [m.TensorDef(0, "in", (1, 4, 4, 2), i8, q),
               m.TensorDef(1, "size", (2,), np.dtype(np.int32), None,
                           np.array([8, 8], np.int32)),
               m.TensorDef(2, "out", (1, 8, 8, 2), i8, q)]
    ops = [m.OpDef(0, "RESIZE_NEAREST_NEIGHBOR", [0, 1], [2], {})]
    return m.GraphDef(tensors, ops, [0], [2])


@pytest.mark.parametrize("graph,factor", [("corpus", 2), ("corpus", 8),
                                          ("resize", 3)])
def test_retarget_equals_jax(jax_corpus, graph, factor):
    if graph == "corpus":
        jg, pg = jax_corpus, load_tflite(CORPUS)
    else:
        jg, pg = _resize_graph(jir), _resize_graph(ir)
    want, got = jax_retarget(jg, factor), retarget_spatial(pg, factor)
    assert (got.name, got.inputs, got.outputs) == \
        (want.name, want.inputs, want.outputs)
    assert len(got.tensors) == len(want.tensors)
    for a, b in zip(got.tensors, want.tensors):
        assert (a.index, a.name, tuple(a.shape), a.dtype) == \
            (b.index, b.name, tuple(b.shape), b.dtype)
        assert (a.qparams is None) == (b.qparams is None)
        if a.qparams is not None:
            assert a.qparams.scales == b.qparams.scales
            assert a.qparams.zero_points == b.qparams.zero_points
        assert (a.data is None) == (b.data is None)
        if a.data is not None:
            np.testing.assert_array_equal(a.data, b.data)
            assert a.data.dtype == b.data.dtype
    assert [(o.opname, o.inputs, o.outputs, o.attrs) for o in got.ops] == \
        [(o.opname, o.inputs, o.outputs, o.attrs) for o in want.ops]
    if graph == "resize":     # the size constant scales; the input's stays
        np.testing.assert_array_equal(got.tensors[1].data, [24, 24])
        np.testing.assert_array_equal(pg.tensors[1].data, [8, 8])


def test_448_plan_structure():
    """Every lowered op in exactly one section, in order; every strip arena
    within the budget; the 56x56 suffix tiled too (the whole-frame arena
    refuses the graph)."""
    g = retarget_spatial(load_tflite(CORPUS), 8)
    with pytest.raises(NotImplementedError, match="budget"):
        arena.build_arena_plan(g)
    lops, _ = arena.lower_arena_ops(g)
    plan = tiled.build_tiled_plan(g)
    assert all(isinstance(s, tiled.Section) for s in plan)
    assert [(s.start, s.end) for s in plan] == \
        list(zip([0] + [s.end for s in plan[:-1]], [s.end for s in plan]))
    assert plan[-1].end == len(lops)
    assert all(s.arena_bytes <= arena.ARENA_BUDGET for s in plan)
    assert all(s.recompute <= tiled.RECOMPUTE_BOUND for s in plan)
    produced = {g.inputs[0]}
    for s in plan:
        assert set(s.inputs) <= produced
        produced |= set(s.outputs)
    assert g.outputs[0] in plan[-1].outputs
    suffix = [s for s in plan
              if arena._hwc(g, lops[s.start].out)[0] == 56]
    assert suffix and all(s.strips >= 2 for s in suffix)
    assert sum(s.end - s.start for s in suffix) >= 15


def test_small_budget_plan_structure():
    """>= 3 sections, >= 2 strips, halo rows recomputed inside a section,
    and both edge strips clipped against the image."""
    g = retarget_spatial(load_tflite(CORPUS), 2)
    plan = tiled.build_tiled_plan(g, SMALL)
    assert len(plan) >= 3
    assert all(isinstance(s, tiled.Section) and s.arena_bytes <= SMALL
               for s in plan)
    assert max(s.strips for s in plan) >= 2
    assert max(s.recompute for s in plan) > 1.0
    top = bottom = False
    for s in plan:
        if s.strips < 2:
            continue
        for t, band in s.bands.items():
            h = arena._hwc(g, t)[0]
            top |= -band.a < 0                        # strip 0 above row 0
            y_last = (s.strips - 1) * band.m - band.a
            bottom |= y_last + band.rows > h          # last strip below
    assert top and bottom


@pytest.mark.parametrize("mode,factor,n,budget", [
    ("tiled2", 2, 2, arena.ARENA_BUDGET), ("tiled2", 2, 2, SMALL),
    ("tiled", 2, 2, arena.ARENA_BUDGET), ("tiled", 2, 2, SMALL),
    ("tiled_exact", 2, 2, arena.ARENA_BUDGET), ("tiled_exact", 2, 2, SMALL),
    ("tiled2", 8, 1, arena.ARENA_BUDGET),
    ("tiled_exact", 8, 1, arena.ARENA_BUDGET)])
def test_tiled_sections_equal_jax(jax_corpus, mode, factor, n, budget):
    """Every section input and output of the tiled mode equals the JAX
    engine of the same bits; the default budget goes through the engine
    (``Int8Engine(g, mode)``), the small one through ``TiledPlan``."""
    jg = jax_retarget(jax_corpus, factor)
    x = _frames(factor * 10 + n, n, 56 * factor)
    want = JaxEngine(jg, TILED_BITS[mode]).run_with_intermediates(x)
    g = graph_from_jax(jg)
    if budget == arena.ARENA_BUDGET:
        eng = Int8Engine(g, mode, device="cpu")
        plan = eng.arena
        got = eng.run_with_intermediates(x)
    else:
        plan = tiled.TiledPlan(g, budget, TILED_BITS[mode])
        got = {k: v.numpy() for k, v in
               plan.run_stages(torch.from_numpy(x)).items()}
    assert plan.tiled == (factor == 8 or budget == SMALL)
    assert set(got) == {g.inputs[0]} | {o for s in plan.stages
                                        for o in s.outputs}
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]),
                                      err_msg=f"t{k}")


def test_tiled2_equals_jax_pallas_tiled2(jax_corpus, monkeypatch):
    """``tiled2`` against the Pallas section kernel in interpret mode, with
    tests/test_tiled.py's lowered section thresholds and no XLA routing,
    so the JAX side runs four tiled sections and its arena suffix."""
    import yoloface_tpu.kernels.pallas_tiled as pt
    monkeypatch.setenv("YOLOFACE_TPU_TILE_XLA", "none")
    monkeypatch.setattr(pt, "TILE_THRESHOLD", 1_500_000)
    monkeypatch.setattr(pt, "_NW_CAP", 2)
    monkeypatch.setattr(pt, "_VMEM_TARGET", 1)
    monkeypatch.setattr(pt, "_CHUNK_TARGET", 1 << 20)
    jg = jax_retarget(jax_corpus, 2)
    sections, _ = pt.plan_tiled_split(jg)
    assert len(sections) == 4
    x = _frames(0, 2, 112)
    want = np.asarray(JaxEngine(jg, "pallas_tiled2")(x))
    g = graph_from_jax(jg)
    got = Int8Engine(g, "tiled2", device="cpu")(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    plan = tiled.TiledPlan(g, SMALL, "fast2")
    got_small = plan.run_stages(torch.from_numpy(x))[g.outputs[0]]
    np.testing.assert_array_equal(got_small.numpy(), want)


def _pad_pool_graph(m):
    """tests/test_tiled.py's PAD -> MAX_POOL_2D graph: the PAD's zero-point
    (90) lies above the values, so the border maxes are the pad fill."""
    q = m.QParams((0.05,), (90,))
    pads = np.array([[0, 0], [1, 1], [1, 1], [0, 0]], np.int32)
    i8 = np.dtype(np.int8)
    tensors = [m.TensorDef(0, "in", (1, 12, 12, 4), i8, q),
               m.TensorDef(1, "pads", (4, 2), np.dtype(np.int32), None, pads),
               m.TensorDef(2, "padded", (1, 14, 14, 4), i8, q),
               m.TensorDef(3, "out", (1, 7, 7, 4), i8, q)]
    ops = [m.OpDef(0, "PAD", [0, 1], [2], {}),
           m.OpDef(1, "MAX_POOL_2D", [2], [3],
                   {"padding": "VALID", "stride_w": 2, "stride_h": 2,
                    "filter_w": 2, "filter_h": 2, "activation": "NONE"})]
    return m.GraphDef(tensors, ops, [0], [3])


def test_pad_into_maxpool_fill_in_strips():
    """An absorbed PAD feeding a max-pool fills with the PAD's zero-point,
    not -128, in the edge strips of a strip program."""
    jg = _pad_pool_graph(jir)
    x = np.random.default_rng(5).integers(-128, 80, (2, 12, 12, 4))
    x = x.astype(np.int8)
    want = np.asarray(JaxEngine(jg, "fast2")(x))
    assert (want[:, 0] == 90).any() and (want[:, -1] == 90).any()
    plan = tiled.TiledPlan(graph_from_jax(jg), 256, "fast2")
    (sec,) = plan.stages
    assert isinstance(sec, tiled.Section) and sec.strips >= 3
    got = plan.run_stages(torch.from_numpy(x))[3]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", ["fast2", "fast", "exact"])
def test_small_graph_plan_is_the_arena_plan(jax_corpus, bits):
    """On the 56-pixel corpus graph, whose whole-frame arena fits, the
    tiled plan is the arena plan, program for program."""
    g = graph_from_jax(jax_corpus)
    plan = tiled.TiledPlan(g, bits=bits)
    want = arena.build_arena_plan(g, bits=bits)
    assert not plan.tiled and len(plan.stages) == len(want)
    for a, b in zip(plan.stages, want):
        np.testing.assert_array_equal(a.descs, b.descs)
        np.testing.assert_array_equal(a.consts, b.consts)
        assert (a.inputs, a.outputs, a.bands) == (b.inputs, b.outputs, None)


def _quantize_graph():
    """A QUANTIZE with a ratio of 2**24: its exact requant's left shift
    would take |x| out of int32."""
    i8 = np.dtype(np.int8)
    tensors = [ir.TensorDef(0, "in", (1, 8, 8, 2), i8,
                            ir.QParams((1.0,), (0,))),
               ir.TensorDef(1, "q", (1, 8, 8, 2), i8,
                            ir.QParams((2.0 ** -24,), (0,)))]
    return ir.GraphDef(tensors, [ir.OpDef(0, "QUANTIZE", [0], [1], {})],
                       [0], [1])


def _logistic_graph():
    q = ir.QParams((0.05,), (3,))
    tensors = [ir.TensorDef(0, "in", (1, 8, 8, 2), np.dtype(np.int8), q),
               ir.TensorDef(1, "out", (1, 8, 8, 2), np.dtype(np.int8), q)]
    return ir.GraphDef(tensors, [ir.OpDef(0, "LOGISTIC", [0], [1], {})],
                       [0], [1])


@pytest.mark.parametrize("mode", ["tiled_exact", "tiled", "tiled2"])
def test_tiled_modes_refuse_what_arena_modes_refuse(mode):
    """Whole frame or in strips (a budget below one frame's arena), a tiled
    mode refuses the graphs its arena twin refuses, with the same error."""
    twin = {"tiled_exact": "arena_exact", "tiled": "arena",
            "tiled2": "arena2"}[mode]
    cases = [(_logistic_graph(), "LOGISTIC")]
    if mode == "tiled_exact":
        cases.append((_quantize_graph(), "int32"))
    else:       # fast bits take it, in strips too
        Int8Engine(_quantize_graph(), mode, device="cpu")
        assert all(isinstance(s, tiled.Section) for s in
                   tiled.build_tiled_plan(_quantize_graph(), 64,
                                          TILED_BITS[mode]))
    for g, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            Int8Engine(g, twin, device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            Int8Engine(g, mode, device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            tiled.build_tiled_plan(g, 64, TILED_BITS[mode])


def test_section_wrapper_routes_by_device():
    """CPU tensors take the plain version (no launch counted); a tensor on
    another device raises; a whole-frame stage is refused, as is a strip
    program on the arena wrapper."""
    g = retarget_spatial(load_tflite(CORPUS), 2)
    plan = tiled.TiledPlan(g, SMALL)
    sec = plan.stages[0]
    x = torch.from_numpy(_frames(3, 1, 112))
    before = tiled.tiled_section.launches
    (y,) = tiled.tiled_section(sec, plan.descs0, plan.consts0, [x])
    assert tiled.tiled_section.launches == before
    ref = torch.empty_like(y)
    tiled.tiled_section_plain(sec, plan.consts0, [x, ref])
    assert torch.equal(y, ref)
    with pytest.raises(ValueError, match="no tiled section kernel"):
        tiled.tiled_section(sec, plan.descs0.to("meta"),
                            plan.consts0.to("meta"), [x.to("meta")])
    with pytest.raises(ValueError, match="strip program"):
        arena.arena_stage(sec, plan.descs0, plan.consts0, [x])
    whole = arena.ArenaPlan(g)
    with pytest.raises(ValueError, match="whole-frame"):
        tiled.tiled_section(whole.stages[0], whole.descs0, whole.consts0,
                            [x])


def test_golden_448_keys_pinned():
    gold = np.load(GOLDEN)
    for k, digest in DIGESTS448.items():
        assert gold[k].shape == (2, 56, 56, 18) and gold[k].dtype == np.int8
        assert hashlib.sha256(gold[k].tobytes()).hexdigest() == digest, k
    tool = _golden_tool()
    assert str(gold["frames448_sha256"]) == FRAMES448_SHA256
    assert tool.sha256(tool.frames448()) == FRAMES448_SHA256


def test_golden_448_equals_recomputed_jax_side():
    gold = np.load(GOLDEN)
    want = _golden_tool().jax_outputs_448()
    assert sorted(want) == ["frames448_sha256", "head448", "head448_exact"]
    for k, v in want.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)


@pytest.mark.parametrize("mode,key", [("tiled2", "head448"),
                                      ("tiled_exact", "head448_exact")])
def test_448_entry_point_on_golden_frames(mode, key):
    """``Int8Engine(retarget_spatial(load_tflite(corpus), 8), mode)`` on
    the golden 448 frames gives the golden output."""
    eng = Int8Engine(retarget_spatial(load_tflite(CORPUS), 8), mode,
                     device="cpu")
    y = eng(torch.from_numpy(_golden_tool().frames448()))
    assert y.shape == (2, 56, 56, 18) and y.dtype == torch.int8
    np.testing.assert_array_equal(y.numpy(), np.load(GOLDEN)[key])
