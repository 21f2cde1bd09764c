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
are pinned by sha256 and recomputed.

The rest of the op surface in strips (under a budget that forces them):
fuzz seeds 0-7, the v3-tiny FPN (also against JAX ``pallas_tiled2``, and
``pallas_tiled_exact`` under ``slow``: 13 s in interpret mode), the
op-surface graph, the eltwise chain, the configurations at which JAX cuts
its tiled prefix, and the published yolov3-tiny reduced in width
(``tools/make_torch_port_golden.yolov3_tiny_graph``) with its upsample and
concat cut into strips; the .tflite test graphs and their golden keys
against the JAX side recomputed."""

import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import test_darknet_ptq as ptq
from test_tiled_fuzz import (DW5_CFG, STRIDED_1X1_CFG, UPSAMPLE_CFG,
                             _cfg_graph, _int8_graph)
from test_torch_fused import _chain_graph
from yoloface_tpu.graph import ir as jir
from yoloface_tpu.io.darknet_cfg import DarknetNet, template_from_darknet
from yoloface_tpu.quantize.calibrate import calibrate_from_weights
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


def _softmax_graph():
    """A SOFTMAX, which JAX's arena lowering (``pallas_arena.
    lower_arena_ops``) has no branch for either."""
    q = ir.QParams((0.05,), (3,))
    tensors = [ir.TensorDef(0, "in", (1, 8, 8, 2), np.dtype(np.int8), q),
               ir.TensorDef(1, "out", (1, 8, 8, 2), np.dtype(np.int8),
                            ir.QParams((1.0 / 256.0,), (-128,)))]
    return ir.GraphDef(tensors, [ir.OpDef(0, "SOFTMAX", [0], [1], {})],
                       [0], [1])


@pytest.mark.parametrize("mode", ["tiled_exact", "tiled", "tiled2"])
def test_tiled_modes_refuse_what_arena_modes_refuse(mode):
    """Whole frame or in strips (a budget below one frame's arena), a tiled
    mode refuses the graphs its arena twin refuses, with the same error."""
    twin = {"tiled_exact": "arena_exact", "tiled": "arena",
            "tiled2": "arena2"}[mode]
    cases = [(_softmax_graph(), "SOFTMAX")]
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


TOOL = _golden_tool()         # numpy at import; jax only inside functions
JAX_TILED = {"tiled2": "pallas_tiled2", "tiled_exact": "pallas_tiled_exact"}


def _assert_equal(got, want):
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=f"t{k}")


def _strip_plan(g, bits):
    """The tiled plan at the smallest of a few budgets that plans ``g``:
    strips as short as its widest op allows."""
    for budget in (256, 384, 512, 768, 1024, 1536, 2048, 4096):
        try:
            return tiled.TiledPlan(g, budget, bits)
        except NotImplementedError:
            continue
    raise AssertionError("no strip budget plans the graph")


def _sections_equal_jax(g, x, want, bits):
    """The strip plan of ``g``: >= 1 section of >= 2 strips, every section
    output equal to ``want``; -> the plan."""
    plan = _strip_plan(g, bits)
    assert plan.tiled and max(s.strips for s in plan.stages) >= 2
    got = {k: v.numpy() for k, v in
           plan.run_stages(torch.from_numpy(x)).items()}
    assert set(got) == {g.inputs[0]} | {o for s in plan.stages
                                        for o in s.outputs}
    _assert_equal(got, want)
    return plan


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("mode", list(TILED_BITS))
def test_fuzz_sections_equal_jax(seed, mode):
    """Fuzz seeds 0-7 in strips: every section output equals the JAX
    engine of the mode's bits; the whole-frame engine path too."""
    jg, rng = _int8_graph(seed)
    x = rng.integers(-128, 128, (3, 14, 14, 3), dtype=np.int64).astype(np.int8)
    bits = TILED_BITS[mode]
    want = JaxEngine(jg, bits).run_with_intermediates(x)
    g = graph_from_jax(jg)
    _sections_equal_jax(g, x, want, bits)
    _assert_equal(Int8Engine(g, mode, device="cpu").run_with_intermediates(x),
                  want)


@pytest.fixture(scope="module")
def v3tiny():
    """tests/test_darknet_ptq.py's two-headed v3-tiny FPN, int8."""
    net = DarknetNet(ptq.V3_TINY_CFG)
    template, weights = template_from_darknet(net, ptq._random_params(net))
    rep = np.random.default_rng(5).uniform(0, 1, (16, 32, 32, 3))
    return calibrate_from_weights(weights, rep.astype(np.float32), template)


@pytest.mark.parametrize("mode", list(TILED_BITS))
def test_v3tiny_sections_equal_jax(v3tiny, mode):
    """The two-headed FPN in strips, its RESIZE and concat in a section of
    >= 2 strips: every section output equals the JAX engine."""
    x = _frames(11, 2, 32)
    bits = TILED_BITS[mode]
    want = JaxEngine(v3tiny, bits).run_with_intermediates(x)
    plan = _sections_equal_jax(graph_from_jax(v3tiny), x, want, bits)
    assert any(s.strips >= 2 and arena.RESIZE in s.descs[:, arena.F["code"]]
               for s in plan.stages)


@pytest.mark.parametrize("mode", [
    "tiled2", pytest.param("tiled_exact", marks=pytest.mark.slow)])
def test_v3tiny_heads_equal_pallas_tiled(v3tiny, mode, monkeypatch):
    """Both heads in strips equal JAX ``pallas_tiled2`` /
    ``pallas_tiled_exact`` with every plane tiled
    (tests/test_darknet_ptq.py:216): the same bits, though JAX ends its
    tiled prefix at the upsample and the port does not."""
    import yoloface_tpu.kernels.pallas_tiled as pt
    monkeypatch.setenv("YOLOFACE_TPU_TILE_XLA", "none")
    monkeypatch.setattr(pt, "TILE_THRESHOLD", 0)
    monkeypatch.setattr(pt, "_NW_CAP", 2)
    monkeypatch.setattr(pt, "_VMEM_TARGET", 1)
    monkeypatch.setattr(pt, "_CHUNK_TARGET", 1 << 20)
    x = _frames(11, 2, 32)
    want = JaxEngine(v3tiny, JAX_TILED[mode])(x)
    g = graph_from_jax(v3tiny)
    env = _strip_plan(g, TILED_BITS[mode]).run_stages(torch.from_numpy(x))
    for o, w in zip(g.outputs, want):
        np.testing.assert_array_equal(env[o].numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", list(TILED_BITS))
def test_op_surface_in_strips_equals_golden(mode):
    """The op-surface graph in strips (a standalone PAD, LEAKY, RELU,
    RELU6, LOGISTIC and RESIZE in strip programs): every section output
    equals the JAX engine, the outputs the golden keys."""
    g, x = TOOL.surface_graph(), TOOL.surface_frames()
    bits = TILED_BITS[mode]
    want = JaxEngine(TOOL.jax_graph(g), bits).run_with_intermediates(x)
    plan = _sections_equal_jax(g, x, want, bits)
    codes = {c for s in plan.stages if s.strips >= 2
             for c in s.descs[:, arena.F["code"]].tolist()}
    assert {arena.PAD, arena.LEAKY, arena.ACT, arena.RESIZE} <= codes
    gold = np.load(GOLDEN)
    env = plan.run_stages(torch.from_numpy(x))
    for k, o in enumerate(g.outputs):
        np.testing.assert_array_equal(env[o].numpy(),
                                      gold[f"surface_{bits}{k}"])
    for k, y in enumerate(Int8Engine(g, mode, device="cpu")(x)):
        np.testing.assert_array_equal(y.numpy(), gold[f"surface_{bits}{k}"])


@pytest.mark.parametrize("mode", list(TILED_BITS))
def test_eltwise_activation_ops_in_strips(mode):
    """The port's counterpart of tests/test_tiled_fuzz.py::
    test_eltwise_activation_ops in strips: RELU, RELU6, QUANTIZE and
    LOGISTIC row by row equal the JAX engine on every tensor."""
    x = np.random.default_rng(7).integers(-128, 128, (2, 10, 10, 5),
                                          dtype=np.int64).astype(np.int8)
    bits = TILED_BITS[mode]
    want = JaxEngine(_chain_graph(jir), bits).run_with_intermediates(x)
    plan = tiled.TiledPlan(_chain_graph(ir), 256, bits)
    assert [s.strips for s in plan.stages] == [5]
    got = plan.run_stages(torch.from_numpy(x))
    _assert_equal({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("cfg", ["upsample", "strided 1x1", "dw 5x5"])
@pytest.mark.parametrize("mode", list(TILED_BITS))
def test_tiled_prefix_cut_configs_equal_jax(cfg, mode):
    """The port's counterpart of tests/test_tiled_fuzz.py::
    test_tiled_prefix_cut_at_unsupported_op: where JAX ends its tiled
    prefix (an upsample, a strided 1x1 conv, a 5x5 depthwise conv) the
    port runs on in strips, and every section output equals JAX's bits."""
    text = {"upsample": UPSAMPLE_CFG, "strided 1x1": STRIDED_1X1_CFG,
            "dw 5x5": DW5_CFG}[cfg]
    jg, rng = _cfg_graph(text)
    x = rng.integers(-128, 128, (2, 14, 14, 3), dtype=np.int64).astype(np.int8)
    bits = TILED_BITS[mode]
    want = JaxEngine(jg, bits).run_with_intermediates(x)
    plan = _sections_equal_jax(graph_from_jax(jg), x, want, bits)
    assert plan.stages[-1].end == len(arena.lower_arena_ops(
        graph_from_jax(jg), bits)[0])


@pytest.mark.parametrize("size,budget", [(32, arena.ARENA_BUDGET), (32, 400),
                                         (416, 8192)])
@pytest.mark.parametrize("mode", list(TILED_BITS))
def test_yolov3_tiny_reduced_equals_jax(size, budget, mode):
    """The published yolov3-tiny at width / 16: at 32x32 whole-frame (the
    arena plan) and in strips; at 416x416 in strips down to the upsample
    and the concat of route 20, which run in a section of >= 2 strips.
    Every stage or section output equals the JAX engine."""
    g = TOOL.yolov3_tiny_graph(size, 16)
    x = TOOL.yolov3_tiny_frames(1, size)
    bits = TILED_BITS[mode]
    want = JaxEngine(TOOL.jax_graph(g), bits).run_with_intermediates(x)
    plan = tiled.TiledPlan(g, budget, bits)
    assert plan.tiled == (budget < arena.ARENA_BUDGET)
    if size == 416:
        resize = [s for s in plan.stages
                  if arena.RESIZE in s.descs[:, arena.F["code"]]]
        assert resize and resize[0].strips >= 2
    got = plan.run_stages(torch.from_numpy(x))
    _assert_equal({k: v.numpy() for k, v in got.items()}, want)


def test_yolov3_tiny_full_width_graph():
    """The 416 graph is the published one: 2,782,480,896 MACs and 8,845,488
    int8 weights a frame, 13 convs, 11 leakys, 6 max-pools, two
    255-channel heads; every conv inside the exact domain."""
    g = TOOL.yolov3_tiny_graph()
    macs = sum(int(np.prod(g.tensor(op.outputs[0]).shape[1:]))
               * int(np.prod(g.tensor(op.inputs[1]).shape[1:]))
               for op in g.ops if op.opname == "CONV_2D")
    assert macs == 2_782_480_896
    assert sum(g.tensor(op.inputs[1]).data.size for op in g.ops
               if op.opname == "CONV_2D") == 8_845_488
    names = [op.opname for op in g.ops]
    assert [names.count(n) for n in ("CONV_2D", "LEAKY_RELU", "MAX_POOL_2D",
                                     "RESIZE_NEAREST_NEIGHBOR",
                                     "CONCATENATION")] == [13, 11, 6, 1, 1]
    assert [g.tensor(o).shape for o in g.outputs] == [(1, 13, 13, 255),
                                                     (1, 26, 26, 255)]
    arena.lower_arena_ops(g, "exact")         # check_exact_domain holds


def test_golden_tflite_keys_equal_recomputed_jax_side():
    gold = np.load(GOLDEN)
    want = TOOL.jax_outputs_tflite()
    assert sorted(want) == sorted(TOOL.KEYS_TFLITE)
    for k, v in want.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)
    fast2 = TOOL.jax_outputs_surface_fast2()
    assert sorted(fast2) == sorted(TOOL.KEYS_SURFACE_FAST2)
    for k, v in fast2.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)


def test_tflite_files_are_the_exported_graphs(tmp_path, monkeypatch):
    """The committed .tflite test graphs are what the tool writes today
    from tests/test_tiled_fuzz.py and tests/test_darknet_ptq.py."""
    monkeypatch.setattr(TOOL, "tflite_path",
                        lambda name: str(tmp_path / f"{name}.tflite"))
    TOOL.write_tflite_graphs()
    for name in TOOL.TFLITE_GRAPHS:
        with open(tmp_path / f"{name}.tflite", "rb") as f:
            fresh = f.read()
        with open(os.path.join(REPO, "tests", "data",
                               f"{name}_int8.tflite"), "rb") as f:
            assert f.read() == fresh, name
