"""The per-op elementwise table kernel (``kernels/eltwise.py``,
``csrc/eltwise_lut.cu``) against the JAX package on the CPU.

Tolerance 0: the plain table of each RELU, RELU6 and LOGISTIC op equals
JAX's ``activation_int32`` values through ``pallas_int8.eltwise_int8`` (in
interpret mode, as ``tests/test_torch_perop.py`` runs the per-op kernels)
on all 256 int8 inputs, at the op-surface graph's quantizations and at the
yolov3-tiny upsample's (``chip_smoke._upsample_graph``).  The kernel itself
runs on the card only (``tests/test_torch_gpu.py``); here the wrapper takes
its plain version."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.kernels import pallas_int8 as pk
from yoloface_tpu_torch.kernels import arena, eltwise, perop
from yoloface_tpu_torch.runtime.engine import PEROP_BITS, Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
GRAPHS = {"op surface": TOOL.surface_graph,
          "upsample": lambda: SMOKE._upsample_graph(TOOL)}
ACTS = ("RELU", "RELU6", "LOGISTIC")


def _table_ops(g, bits="fast"):
    """[(graph op, per-op stage, its descriptor row)] of the activation
    programs the card runs on the table kernel, in graph order."""
    plan = perop.PerOpPlan(g, bits)
    routed = [(st, getattr(plan, f"descs{k}"))
              for k, st in enumerate(plan.stages)
              if perop.card_kernel(st) == "eltwise_lut"
              and st.kernel == "eltwise_int8"]
    ops = [op for op in g.ops if op.opname in ACTS]
    assert len(ops) == len(routed) == 3
    return [(op, st, d) for op, (st, d) in zip(ops, routed)]


@pytest.mark.parametrize("graph,k", [(g, k) for g in GRAPHS
                                     for k in range(3)])
def test_plain_table_equals_jax_activation(graph, k):
    """The plain table of each ACT op equals JAX ``eltwise_int8`` over
    ``activation_int32`` on all 256 int8 inputs."""
    g = GRAPHS[graph]()
    op, _, desc = _table_ops(g)[k]
    jg = TOOL.jax_graph(g)
    fn = pk.activation_int32(op.opname, jg.tensor(op.inputs[0]).qparams)
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 16, 16, 1)
    want = np.asarray(pk.eltwise_int8(jnp.asarray(every), fn)).reshape(-1)
    got = eltwise.table_plain(desc).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2                     # the op acts


@pytest.mark.parametrize("bits", perop.BITS)
def test_perop_plan_routes_exactly_its_act_programs(bits):
    """On the op-surface graph the table kernel takes the ACT programs
    (the B8 kernel ``eltwise_int8``), the standalone LEAKY program
    (``leaky_int8``) and the QUANTIZE program (``requantize_int8``) and
    nothing else."""
    plan = perop.PerOpPlan(TOOL.surface_graph(), bits)
    routed = [k for k, st in enumerate(plan.stages)
              if perop.card_kernel(st) == "eltwise_lut"]
    acts = [k for k, st in enumerate(plan.stages)
            if st.descs[0, F["code"]] in eltwise.TABLE_CODES]
    assert routed == acts and len(acts) == 5
    assert [plan.stages[k].kernel for k in routed].count("eltwise_int8") == 3
    assert {plan.stages[k].kernel for k in routed} == {
        "eltwise_int8", "leaky_int8", "requantize_int8"}
    assert {perop.card_kernel(st) for st in plan.stages
            if st.kernel == "leaky_int8"} == {"eltwise_lut"}


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("bits", perop.BITS)
def test_wrapper_on_cpu_equals_the_perop_program(graph, bits):
    """On CPU tensors the wrapper (its plain version) equals the per-op
    program's plain executor on each ACT op, on seeded frames and on a
    view one byte into its storage."""
    rng = np.random.default_rng(7)
    for op, st, desc in _table_ops(GRAPHS[graph](), bits):
        shape = st.shapes[st.inputs[0]]
        buf = torch.from_numpy(rng.integers(
            -128, 128, 1 + 3 * int(np.prod(shape))).astype(np.int8))
        for x in (buf[:-1].view(3, *shape), buf[1:].view(3, *shape)):
            want = torch.empty_like(x)
            perop.perop_plain(st, torch.from_numpy(st.consts), [x, want])
            assert torch.equal(eltwise.eltwise_lut(desc, x), want), op.opname


REFUSED = {
    "float input": (lambda x: x.float(), "int8"),
    "strided input": (lambda x: x.permute(0, 3, 1, 2), "contiguous"),
    "another device": (lambda x: x.to("meta"), "no elementwise kernel"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses(case):
    _, _, desc = _table_ops(TOOL.surface_graph())[0]
    change, match = REFUSED[case]
    x = change(torch.zeros((2, 4, 4, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match=match):
        eltwise.eltwise_lut(desc.to(x.device), x)


def test_wrapper_refuses_a_program_that_is_not_an_activation():
    """A program outside the table kernel's op codes (the max-pool, on the
    fused-stage kernel) is refused."""
    plan = perop.PerOpPlan(TOOL.surface_graph())
    k = next(k for k, st in enumerate(plan.stages)
             if st.kernel == "maxpool_int8")
    with pytest.raises(ValueError, match="ACT, LEAKY and QUANTIZE ops"):
        eltwise.eltwise_lut(getattr(plan, f"descs{k}"),
                            torch.zeros((1, 8, 8, 8), dtype=torch.int8))


@pytest.mark.parametrize("mode", sorted(PEROP_BITS))
def test_cpu_engine_outputs_unchanged(mode):
    """``Int8Engine(surface, mode, device="cpu")`` still gives the golden
    keys, with no launch of the table kernel."""
    gold = np.load(GOLDEN)
    eltwise.eltwise_lut.launches = 0
    ys = Int8Engine(TOOL.surface_graph(), mode, device="cpu")(
        torch.from_numpy(TOOL.surface_frames()))
    for k, y in enumerate(ys):
        np.testing.assert_array_equal(
            y.numpy(), gold[f"surface_{PEROP_BITS[mode]}{k}"])
    assert eltwise.eltwise_lut.launches == 0
