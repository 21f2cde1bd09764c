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


# the tensor-core convs: the planner's marks (every CONV for the bodies of
# csrc/stage_ops.cuh, the big-K ones also for csrc/conv_mma.cuh) and the
# packed B fragments, which the CPU cannot run, held by their plain meaning
MMA_PLANS = {   # name: (graph, budget); each plan cuts the net into sections
    "v3tiny64": (lambda: TOOL.yolov3_tiny_graph(64, 8), 4096),
    "v3tiny96": (lambda: TOOL.yolov3_tiny_graph(96, 2), 16384),
    "v3tiny416": (lambda: TOOL.yolov3_tiny_graph(), arena.ARENA_BUDGET),
    "corpus448": (lambda: retarget_spatial(load_tflite(CORPUS), 8),
                  arena.ARENA_BUDGET),
}
# sha256 of each plan's programs as planned before the tensor-core convs
# existed, strips sized for a quarter of the budget (TARGET_SHARE 4): every
# section's descriptors, then its constants zero-padded to 16 bytes
# (_program_digest)
PROGRAM_DIGESTS = {
    ("v3tiny64", "fast2"):
        "8b2657a2819669e4dd818e0b82aeaf61f0d79bbdcd4574c54774a3cab429d332",
    ("v3tiny64", "fast"):
        "460b6e6f117235617a1d5339a5fbc8250c7e9769abca22038bad505b550f5e0e",
    ("v3tiny64", "exact"):
        "ddcc4f6228bce5b0b049d7fa6dd0fe5baa130fbdbe89465c8cff5dd50bfc642b",
    ("v3tiny96", "fast2"):
        "a101dcbd061eba99800c6be94b1fd70c8b6a1b1ae29c9f107e8fbd5f10308257",
    ("v3tiny96", "fast"):
        "1e53f9b96a8752a64a6303a98712a829aa9a9aa6b7a4bcebaaa5ddd144c7a6e6",
    ("v3tiny96", "exact"):
        "217bc2baa735eb8c4ee0b51d827644accfa54d49d079131cccf05ac27a597d0b",
    ("v3tiny416", "fast2"):
        "00f8232742634929b27437b6e40d58a94f393bd58ec7caad3f233dba2db1bc55",
    ("v3tiny416", "fast"):
        "ac05af285ba9fd43330a388978d9467024877772c205adc4b6aba17bdd36abb4",
    ("v3tiny416", "exact"):
        "b1603e48d6cf151c54ffeb5a355775aec73e125d51d9ab98b829e2c9ae5ef41c",
    ("corpus448", "fast2"):
        "4a3be50e3cfadb01f37824acbdab4eaf14cc25d48c63250e67bc81d75eafcb89",
    ("corpus448", "fast"):
        "fd04520e6ad485813d25a4b76b42ed62c0810334baa9f3523327fdf0d74cd362",
    ("corpus448", "exact"):
        "396746c23bf1279bfed7ea8f4bf7444c1109932168e3f260d7937935f12ab467",
}
# the same at the strip share the section kernel's 3 blocks an SM chose
# (TARGET_SHARE 3): different strips and section cuts, the same ops
PROGRAM_DIGESTS3 = {
    ("v3tiny64", "fast2"):
        "cb34baf2a0bf74ecb9e31665dadae46a1e6f8434878af3d78b170f01ae007c22",
    ("v3tiny64", "fast"):
        "4491a1435dffb93af23db745add36fefd6d76f6750e4475f295502d728afc1bb",
    ("v3tiny64", "exact"):
        "1338b954e56e544b868aae0b1a02d7285449060e27f838093cd2162b5c3d58c4",
    ("v3tiny96", "fast2"):
        "b4a242d3be8aa5bcf58bce51e96b1ab578fa6b256ebf243f601aa7439e8facec",
    ("v3tiny96", "fast"):
        "9c99f8d870236169868cf0130e6c8d8744228352c9357ad8c2edd7892915e31b",
    ("v3tiny96", "exact"):
        "f74e2fce78e48e14dc0b7783b951609017e7c7d1037cdae8103f23299715709e",
    ("v3tiny416", "fast2"):
        "930028d0e6e60e4986fea2d13bdfa0435519df0a194a10a6889d607927618fb5",
    ("v3tiny416", "fast"):
        "e7472b4d4159d5f338a98b55ba031c0750a22876dc5a41ffa7b787f2fc6f9c6c",
    ("v3tiny416", "exact"):
        "5732f319a529a5a8b6976c15162b12e68b7c81aad3679c7e5b7e4cf448ea37e7",
    ("corpus448", "fast2"):
        "361a5d7eda869828ce8b78d6dac8b4108cf1b6647e1a085689f8fe3183181bdc",
    ("corpus448", "fast"):
        "5504eee52d88769278190a613a9e2988b91f136a4014aa691f1ee233b5011b51",
    ("corpus448", "exact"):
        "579daa6a8c757b709f13614ac799906a959fad3804fba70ac6b08384be4940ec",
}
MMA = arena.F[arena.MMA_FIELD]
FRAG = arena.F[arena.FRAG_FIELD]


def _mma_plan(name, bits="fast2"):
    graph, budget = MMA_PLANS[name]
    stages = tiled.build_tiled_plan(graph(), budget, bits)
    assert all(isinstance(s, tiled.Section) for s in stages)
    return stages


def _program_digest(stages):
    """sha256 over the sections' programs, each with its ``FRAG_FIELD`` and
    ``MMA_FIELD`` marks zeroed and its constants cut where the first packed
    copy starts (they are appended after the rest)."""
    h = hashlib.sha256()
    for s in stages:
        descs, consts = s.descs.copy(), s.consts.tobytes()
        marks = descs[:, [FRAG, MMA]]
        if marks.any():
            consts = consts[:int(marks[marks != 0].min())]
            descs[:, [FRAG, MMA]] = 0
        h.update(descs.tobytes())
        h.update(consts + b"\0" * (-len(consts) % 16))
    return h.hexdigest()


def _marked(d):
    """Whether a strip descriptor is a conv the planner should mark for
    the k32 body."""
    F = arena.F
    ci = int(d[F["in0_c"]])
    return (d[F["code"]] == arena.CONV and ci % 16 == 0
            and d[F["kh"]] * d[F["kw"]] * ci >= tiled.MMA_MIN_K)


@pytest.mark.parametrize("share", [3, 4])
@pytest.mark.parametrize("bits", list(arena.BITS))
@pytest.mark.parametrize("name", list(MMA_PLANS))
def test_programs_unchanged_but_for_the_mma_marks(name, bits, share,
                                                 monkeypatch):
    """Every CONV of every section carries a fragment mark
    (``Section.mma_convs`` counts them: the 448 net's 16 1x1s and its
    stem), and exactly the convs ``MMA_MIN_K`` names also a k32 mark
    (``Section.k32_convs``, which picks the k32 instantiation; none in the
    448 net); with the marks and the packed copies taken away every
    program is byte-identical to its form before the tensor-core convs at
    strips sized for a quarter of the budget, and to its pinned form at
    the third the planner takes now.  With no conv past the threshold no
    k32 mark is left, and the programs are so again."""
    assert tiled.TARGET_SHARE == 3
    monkeypatch.setattr(tiled, "TARGET_SHARE", share)
    pins = PROGRAM_DIGESTS if share == 4 else PROGRAM_DIGESTS3
    stages = _mma_plan(name, bits)
    F = arena.F
    for s in stages:
        convs = s.descs[:, F["code"]] == arena.CONV
        assert np.array_equal(s.descs[:, FRAG] != 0, convs)
        want = [_marked(d) for d in s.descs]
        assert [bool(v) for v in s.descs[:, MMA]] == want
        assert s.mma_convs == int(convs.sum())
        assert s.k32_convs == sum(want)
    assert _program_digest(stages) == pins[(name, bits)]
    assert any(s.k32_convs for s in stages) == (name != "corpus448")
    if name == "corpus448":
        assert sum(s.mma_convs for s in stages) == 17
    monkeypatch.setattr(tiled, "MMA_MIN_K", 1 << 30)
    stages = _mma_plan(name, bits)
    assert not any(s.k32_convs for s in stages)
    assert _program_digest(stages) == pins[(name, bits)]


def _unpack_frags(frags, co, k):
    """The plain meaning of ``arena.pack_frags``: lane ``4 * g + t`` of n8
    tile ``n`` at k16 step ``s`` holds W[8n + g][16s + 4t + b] at byte b;
    -> [nt * 8, ks * 16] int8."""
    nt, ks = frags.shape[:2]
    w = np.zeros((nt * 8, ks * 16), np.int8)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for b in range(4):
            w[np.arange(nt)[:, None] * 8 + g,
              np.arange(ks)[None, :] * 16 + 4 * t + b] = frags[:, :, lane, b]
    return w


FRAG_PLANS = {"v3tiny64": MMA_PLANS["v3tiny64"],
              "v3tiny416": MMA_PLANS["v3tiny416"],
              "corpus448": MMA_PLANS["corpus448"]}


@pytest.mark.parametrize("bits", list(arena.BITS))
@pytest.mark.parametrize("name", list(FRAG_PLANS))
def test_section_fragments_unpack_to_the_weights(name, bits):
    """Every CONV of every section (the 448 net's 1x1s and stem, ci 3; all
    of yolov3-tiny's at 416 and 64, its stem included) carries m16n8k16
    fragments (``arena.pack_frags``) that, read back lane by lane, are its
    OHWI weights flattened per output channel in (dy, dx, c) order, with co
    zero-padded to a multiple of 8 and K to one of 16."""
    F = arena.F
    seen = set()
    for s in _mma_plan(name, bits):
        for d in s.descs:
            if d[F["code"]] != arena.CONV:
                continue
            d = [int(v) for v in d]
            co, kh, kw, ci = (d[F["out_c"]], d[F["kh"]], d[F["kw"]],
                              d[F["in0_c"]])
            k = kh * kw * ci
            nt, ks = -(-co // 8), -(-k // arena.FRAG_K)
            assert d[FRAG] % 16 == 0 and d[FRAG] > d[F["w_off"]]
            raw = s.consts[d[FRAG]:d[FRAG] + nt * ks * 32 * 4]
            got = _unpack_frags(raw.view(np.int8).reshape(nt, ks, 32, 4),
                                co, k)
            w = s.consts[d[F["w_off"]]:d[F["w_off"]] + co * k].view(np.int8)
            want = np.zeros((nt * 8, ks * 16), np.int8)
            want[:co, :k] = w.reshape(co, k)
            np.testing.assert_array_equal(got, want)
            seen.add((kh, kw, ci))
    assert (3, 3, 3) in seen            # the stem


SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
SMOKE_MOD = importlib.util.module_from_spec(SMOKE)
SMOKE.loader.exec_module(SMOKE_MOD)
SCRATCH_GRAPHS = {
    "corpus448": lambda: retarget_spatial(load_tflite(CORPUS), 8),
    "v3tiny64": lambda: TOOL.yolov3_tiny_graph(64, 8),
    "pools": TOOL.pool_graph,
    "surface": TOOL.surface_graph,
}


@pytest.mark.parametrize("bits", list(arena.BITS))
@pytest.mark.parametrize("name", list(SCRATCH_GRAPHS))
def test_section_arena_and_pool_scratch_fit_the_budget(name, bits):
    """At every budget of ``chip_smoke.STRIP_BUDGETS`` that plans the
    graph, in each bit semantics, every section's launch takes its strip
    arena and, where the planner gave its max-pools a scratch, that
    scratch (``arena.pool_scratch`` over its strips' rows) past the arena,
    all within the budget; the scratch is given exactly where it fits."""
    graph = SCRATCH_GRAPHS[name]()
    planned = 0
    for budget in SMOKE_MOD.STRIP_BUDGETS + (arena.ARENA_BUDGET,):
        try:
            stages = tiled.build_tiled_plan(graph, budget, bits)
        except NotImplementedError:
            continue
        for s in stages:
            if not isinstance(s, tiled.Section):
                continue
            planned += 1
            scratch = arena.pool_scratch(s.descs, staged=False)
            assert s.smem_bytes <= budget
            if scratch and s.arena_bytes + scratch <= budget:
                assert (s.scratch_off, s.smem_bytes) == (
                    s.arena_bytes, s.arena_bytes + scratch)
                assert s.scratch_off % 16 == 0
            else:
                assert (s.scratch_off, s.smem_bytes) == (0, s.arena_bytes)
    assert planned


def _unpack_mma(frags, co, kh, kw, ci):
    """The plain meaning of ``tiled.pack_mma``: lane ``4 * g + t`` of n8
    tile ``n`` at k32 step ``s`` holds W[8n + g][32s + 4t + b] at byte b
    and W[8n + g][32s + 16 + 4t + b] at byte 4 + b; -> OHWI [nt * 8, kh,
    kw, ci padded to 32] int8."""
    frags = torch.as_tensor(frags)
    nt, ks = frags.shape[:2]
    w = torch.zeros((nt * 8, ks * 32), dtype=torch.int8)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for half in range(2):
            for b in range(4):
                k = torch.arange(ks) * 32 + 16 * half + 4 * t + b
                w[torch.arange(nt)[:, None] * 8 + g, k[None, :]] = \
                    frags[:, :, lane, 4 * half + b]
    return w.reshape(nt * 8, kh, kw, -1)


def _marked_convs(name, bits, monkeypatch):
    """(section, descriptor) of every marked conv of the plan; the 448
    net's 1x1s (K 32 and 48) marked too."""
    if name == "corpus448":
        monkeypatch.setattr(tiled, "MMA_MIN_K", 16)
    got = [(s, [int(v) for v in d]) for s in _mma_plan(name, bits)
           for d in s.descs if d[MMA]]
    assert got
    return got


@pytest.mark.parametrize("name", ["v3tiny64", "v3tiny416", "corpus448"])
def test_packed_fragments_unpack_to_the_weights(name, monkeypatch):
    """Each marked conv's packed copy, read back lane by lane, is its OHWI
    weights with co zero-padded to a multiple of 8 and each tap's ci to a
    multiple of 32."""
    F = arena.F
    for s, d in _marked_convs(name, "fast2", monkeypatch):
        co, kh, kw, ci = d[F["out_c"]], d[F["kh"]], d[F["kw"]], d[F["in0_c"]]
        cp, nt = -(-ci // 32) * 32, -(-co // 8)
        frags = s.consts[d[MMA]:d[MMA] + nt * 8 * kh * kw * cp]
        got = _unpack_mma(frags.view(np.int8).reshape(nt, -1, 32, 8), co, kh,
                          kw, ci)
        w = s.consts[d[F["w_off"]]:d[F["w_off"]] + co * kh * kw * ci]
        want = torch.zeros((nt * 8, kh, kw, cp), dtype=torch.int8)
        want[:co, :, :, :ci] = torch.from_numpy(
            w.view(np.int8).reshape(co, kh, kw, ci).copy())
        assert torch.equal(got, want)


@pytest.mark.parametrize("bits", list(arena.BITS))
@pytest.mark.parametrize("name", ["v3tiny64", "corpus448"])
def test_packed_gemm_equals_plain_accumulators(name, bits, monkeypatch):
    """The tensor-core conv as an int32 GEMM over the packed layout: the
    im2col of a random input with the fill at every tap outside the image
    (and in the padded channels), times the unpacked fragments, plus the
    bias, equals the accumulators of the section's plain version
    (``_conv_acc`` over the fill-padded window) at every output pixel."""
    F = arena.F
    rng = np.random.default_rng(61)
    for s, d in _marked_convs(name, bits, monkeypatch):
        co, kh, kw, ci = d[F["out_c"]], d[F["kh"]], d[F["kw"]], d[F["in0_c"]]
        sh, sw, pt, pl, fill = (d[F[k]] for k in ("sh", "sw", "pt", "pl",
                                                  "fill"))
        in0 = arena.View(*d[F["in0_space"]:F["in0_space"] + 6])
        out = arena.View(*d[F["out_space"]:F["out_space"] + 6])
        x = torch.from_numpy(rng.integers(-128, 128, (2, in0.h, in0.w, ci),
                                          dtype=np.int64).astype(np.int8))
        consts = torch.from_numpy(s.consts)
        w = arena._const(consts, d[F["w_off"]], co * kh * kw * ci,
                         torch.int8).reshape(co, kh, kw, ci)
        bias = arena._const(consts, d[F["b_off"]], co, torch.int32)
        want = arena._conv_acc(arena._padded_window(x, 0, d, in0, out, 0,
                                                    out.h), w, (sh, sw))
        cp, nt = -(-ci // 32) * 32, -(-co // 8)
        frags = s.consts[d[MMA]:d[MMA] + nt * 8 * kh * kw * cp]
        b = _unpack_mma(frags.view(np.int8).reshape(nt, -1, 32, 8), co, kh,
                        kw, ci).reshape(nt * 8, -1).to(torch.int64)
        xp = torch.full((2, in0.h + 2 * kh, in0.w + 2 * kw, cp), fill,
                        dtype=torch.int64)
        xp[:, kh:kh + in0.h, kw:kw + in0.w, :ci] = x
        oy = torch.arange(out.h)[:, None] * sh - pt + kh
        ox = torch.arange(out.w)[None, :] * sw - pl + kw
        cols = torch.stack([xp[:, oy + dy, ox + dx] for dy in range(kh)
                            for dx in range(kw)], 3)
        acc = cols.reshape(2, out.h, out.w, -1) @ b.T
        assert torch.equal((acc[..., :co] + bias).to(torch.int32),
                           want + bias), (name, d[F["out_c"]], ci)
