"""The per-op standalone LEAKY_RELU on the flat table kernel
(``kernels/eltwise.py``, ``csrc/eltwise_lut.cu``) against the JAX package
on the CPU.

Tolerance 0, exhaustively: the plain table of every standalone LEAKY the
repository's graphs keep as a per-op program (one in the op-surface graph,
one in the yolov3-tiny upsample of ``chip_smoke._upsample_graph``, 16 at
different scales in the 17-input concat of
``tools/make_torch_port_golden.wide_move_graphs``) equals JAX
``pallas_int8.leaky_int8`` on all 256 int8 inputs, in fast and exact bits
(the JAX kernel in interpret mode, as ``tests/test_torch_perop.py`` runs
it, with that file's specs).  The programs route to the table kernel, the
wrapper (its plain version here) equals the per-op program's plain
executor on them, the other op codes are refused, and the CPU engine's
outputs are unchanged.  The kernel runs on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import hashlib
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_perop import _jax_op
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena, eltwise, perop
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
# the graphs that keep standalone LEAKYs, and how many each keeps
GRAPHS = {"op surface": (TOOL.surface_graph, 1),
          "upsample": (lambda: SMOKE._upsample_graph(TOOL), 1),
          "17 distinct inputs":
              (lambda: TOOL.wide_move_graphs()["17 distinct inputs"][0], 16)}
CASES = [(g, k) for g, (_, n) in GRAPHS.items() for k in range(n)]
# sha256 of the per-op programs (each program's descriptors, then its
# constants) of the graphs the op-surface pins of
# tests/test_torch_stage_mma.py do not cover, as planned before the
# standalone LEAKY moved to the table kernel: routing it changed no program
PROGRAM_DIGESTS = {
    ("upsample", "fast"):
        "9c7e2c1186221723e5576d99260d7230bec47e6d47cfa95a96602c0ba8786263",
    ("upsample", "exact"):
        "c32f23bb923820b02cd8ec0ae0a911bb44436fb1866bbf18fcca29fc76216164",
    ("17 distinct inputs", "fast"):
        "b4ca8283aa26a55c7b87bffa79a4ff6832a553547e49b3a780d6cbbfc617d4e4",
    ("17 distinct inputs", "exact"):
        "ef56d672f39fabbd67ed9dfe91cbca87e5c04b6824e109337e50f48b61833bfd",
}


def _leaky_programs(g, bits):
    """[(graph op, per-op stage, its descriptor row)] of the standalone
    LEAKY programs of ``g``, in graph order."""
    plan = perop.PerOpPlan(g, bits)
    progs = [(st, getattr(plan, f"descs{k}"))
             for k, st in enumerate(plan.stages) if st.kernel == "leaky_int8"]
    ops = [op for op in g.ops if op.opname == "LEAKY_RELU"
           and any(st.outputs == [op.outputs[0]] for st, _ in progs)]
    assert len(ops) == len(progs)
    return [(op, st, d) for op, (st, d) in zip(ops, progs)]


@pytest.mark.parametrize("bits", perop.BITS)
@pytest.mark.parametrize("graph,k", CASES)
def test_leaky_table_equals_jax_on_all_inputs(graph, k, bits):
    """The plain table of the k-th standalone LEAKY equals JAX
    ``leaky_int8`` on all 256 int8 inputs; the program routes to the
    table kernel."""
    g = GRAPHS[graph][0]()
    progs = _leaky_programs(g, bits)
    assert len(progs) == GRAPHS[graph][1]
    op, st, desc = progs[k]
    assert perop.card_kernel(st) == "eltwise_lut"
    jg = TOOL.jax_graph(g)
    one = types.SimpleNamespace(ops=[jg.ops[op.index]], tensor=jg.tensor)
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 16, 16, 1)
    want = np.asarray(_jax_op(one, bits == "exact",
                              jnp.asarray(every.transpose(3, 2, 1, 0)))
                      ).transpose(3, 2, 1, 0).reshape(-1)
    got = eltwise.table_plain(desc).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 40                    # the op acts


@pytest.mark.parametrize("graph,bits", sorted(PROGRAM_DIGESTS))
def test_programs_unchanged(graph, bits):
    """The per-op programs of the graphs with standalone LEAKYs are the
    ones planned before (the op-surface graph's are pinned in
    tests/test_torch_stage_mma.py)."""
    h = hashlib.sha256()
    for st in perop.build_perop_plan(GRAPHS[graph][0](), bits):
        h.update(st.descs.tobytes())
        h.update(st.consts.tobytes())
    assert h.hexdigest() == PROGRAM_DIGESTS[(graph, bits)]


@pytest.mark.parametrize("bits", perop.BITS)
def test_graphs_that_fuse_every_leaky_keep_no_program(bits):
    """The corpus, the fuzz graphs and the v3-tiny FPN absorb every LEAKY
    into a conv epilogue: their per-op plans hold no ``leaky_int8``
    program, so only the graphs of ``GRAPHS`` reach the table kernel's
    LEAKY."""
    graphs = [load_tflite(CORPUS)] + [load_tflite(TOOL.tflite_path(name))
                                      for name in TOOL.TFLITE_GRAPHS]
    for g in graphs:
        assert not [st for st in perop.PerOpPlan(g, bits).stages
                    if st.kernel == "leaky_int8"], g.name


@pytest.mark.parametrize("bits", perop.BITS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_wrapper_on_cpu_equals_the_perop_program(graph, bits):
    """On CPU tensors the wrapper (its plain version) equals the per-op
    program's plain executor on each standalone LEAKY, on seeded frames
    and on a view one byte into its storage, with no launch counted."""
    rng = np.random.default_rng(11)
    eltwise.eltwise_lut.launches = 0
    for op, st, desc in _leaky_programs(GRAPHS[graph][0](), bits):
        shape = st.shapes[st.inputs[0]]
        buf = torch.from_numpy(rng.integers(
            -128, 128, 1 + 3 * int(np.prod(shape))).astype(np.int8))
        for x in (buf[:-1].view(3, *shape), buf[1:].view(3, *shape)):
            want = torch.empty_like(x)
            perop.perop_plain(st, torch.from_numpy(st.consts), [x, want])
            assert torch.equal(eltwise.eltwise_lut(desc, x), want), op.index
            got = perop.perop_op(st, desc, torch.from_numpy(st.consts), [x])
            assert torch.equal(got[0], want), op.index
    assert eltwise.eltwise_lut.launches == 0


@pytest.mark.parametrize("kernel", ["conv1x1", "dwconv3x3", "maxpool_int8",
                                    "pad_int8", "add_int8", "resize_nearest",
                                    "concat_channels"])
def test_wrapper_refuses_the_other_op_codes(kernel):
    """Every program whose op code is not ACT, LEAKY or QUANTIZE is
    refused by the wrapper and its plain table."""
    plan = perop.PerOpPlan(TOOL.surface_graph())
    k = next(k for k, st in enumerate(plan.stages) if st.kernel == kernel)
    desc = getattr(plan, f"descs{k}")[:1]
    assert desc[0, F["code"]].item() not in eltwise.TABLE_CODES
    with pytest.raises(ValueError, match="ACT, LEAKY and QUANTIZE ops"):
        eltwise.eltwise_lut(desc, torch.zeros((1, 4, 4, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="ACT, LEAKY and QUANTIZE ops"):
        eltwise.table_plain(desc)


@pytest.mark.parametrize("mode", sorted(PEROP_BITS))
def test_cpu_engine_outputs_unchanged(mode):
    """``Int8Engine(surface, mode, device="cpu")`` still gives the golden
    keys, and the 17-input concat of distinct LEAKYs equals the plain
    ``exact`` / ``fast`` engine, with no launch of the table kernel."""
    gold = np.load(GOLDEN)
    eltwise.eltwise_lut.launches = 0
    ys = Int8Engine(TOOL.surface_graph(), mode, device="cpu")(
        torch.from_numpy(TOOL.surface_frames()))
    for k, y in enumerate(ys):
        np.testing.assert_array_equal(
            y.numpy(), gold[f"surface_{PEROP_BITS[mode]}{k}"])
    g, shape = TOOL.wide_move_graphs()["17 distinct inputs"]
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -128, 128, (5, *shape)).astype(np.int8))
    want = Int8Engine(g, PEROP_BITS[mode], device="cpu")(x)
    assert torch.equal(Int8Engine(g, mode, device="cpu")(x), want)
    assert eltwise.eltwise_lut.launches == 0
