"""The per-op QUANTIZE on the flat table kernel and the per-op ADD on the
flat two-input kernel (``kernels/eltwise.py``: ``eltwise_lut`` and
``add_flat``; ``csrc/eltwise_lut.cu`` and ``csrc/add_int8.cu``) against
the JAX package on the CPU.

Tolerance 0, exhaustively: the plain QUANTIZE table of each of the
corpus's three QUANTIZE ops equals JAX ``pallas_int8.requantize_int8`` on
all 256 int8 inputs, and ``add_flat_plain`` at each of its three ADD ops
equals JAX ``pallas_int8.add_int8`` on all 65,536 (a, b) pairs, in fast
and exact bits (the JAX kernels in interpret mode, as
``tests/test_torch_perop.py`` runs them, with that file's specs).  The
wrappers (their plain versions here) equal the per-op programs' plain
executor on every program routed to them in the corpus, the .tflite test
graphs and the op-surface graph; ``x + x``, the refusals and the CPU
engine's outputs close it.  The kernels run on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_perop import _jax_op
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.kernels import pallas_int8 as pk
from yoloface_tpu_torch.convert import graph_from_jax
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
ROUTES = ("eltwise_lut", perop.ADD_KERNEL)


@pytest.fixture(scope="module")
def corpus():
    return jax_load_tflite(CORPUS)


def _corpus_ops(jg, opname, bits):
    """[(JAX op, its per-op stage)] of the corpus ops named ``opname``."""
    stages = {st.outputs[0]: st
              for st in perop.build_perop_plan(graph_from_jax(jg), bits)}
    ops = [op for op in jg.ops if op.opname == opname]
    assert len(ops) == 3
    return [(op, stages[op.outputs[0]]) for op in ops]


def _jax(jg, op, bits, *xs):
    """JAX's kernel for the one op ``op`` of ``jg`` on NHWC int8 arrays."""
    one = types.SimpleNamespace(ops=[op], tensor=jg.tensor)
    y = _jax_op(one, bits == "exact",
                *[jnp.asarray(x.transpose(3, 2, 1, 0)) for x in xs])
    return np.asarray(y).transpose(3, 2, 1, 0)


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("bits", perop.BITS)
def test_quantize_table_equals_jax_on_all_inputs(corpus, bits, k):
    """The plain table of the corpus's k-th QUANTIZE equals JAX
    ``requantize_int8`` on all 256 int8 inputs; the program routes to the
    table kernel."""
    op, st = _corpus_ops(corpus, "QUANTIZE", bits)[k]
    assert st.kernel == "requantize_int8"
    assert perop.card_kernel(st) == "eltwise_lut"
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 16, 16, 1)
    want = _jax(corpus, op, bits, every).reshape(-1)
    got = eltwise.table_plain(torch.from_numpy(st.descs[0])).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2                     # the op acts


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("bits", perop.BITS)
def test_add_equals_jax_on_all_pairs(corpus, bits, k):
    """``add_flat_plain`` at the corpus's k-th ADD equals JAX ``add_int8``
    on all 65,536 (a, b) pairs; the program routes to the ADD kernel."""
    op, st = _corpus_ops(corpus, "ADD", bits)[k]
    assert perop.card_kernel(st) == perop.ADD_KERNEL
    v = np.arange(-128, 128, dtype=np.int8)
    a = np.repeat(v, 256).reshape(1, 256, 256, 1)
    b = np.tile(v, 256).reshape(1, 256, 256, 1)
    want = _jax(corpus, op, bits, a, b)
    got = eltwise.add_flat_plain(torch.from_numpy(st.descs[0]),
                                 torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 100                  # the op acts


def _graphs():
    graphs = {"corpus": lambda: load_tflite(CORPUS),
              "op surface": TOOL.surface_graph}
    for name in TOOL.TFLITE_GRAPHS:
        graphs[name] = lambda name=name: load_tflite(TOOL.tflite_path(name))
    return graphs


GRAPHS = _graphs()


def _wrapper(st, desc, xs, out=None):
    """The wrapper ``card_kernel`` names for ``st`` on its inputs."""
    if perop.card_kernel(st) == "eltwise_lut":
        return eltwise.eltwise_lut(desc, xs[0], out=out)
    return eltwise.add_flat(desc, *perop.add_inputs(st, xs), out=out)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("bits", perop.BITS)
def test_wrappers_equal_the_perop_programs(graph, bits):
    """Each QUANTIZE and ADD program (and each activation) the card routes
    to the two flat kernels: the wrapper equals the program's plain
    executor on seeded frames, and on inputs one byte into their storage.
    The corpus has 3 ADDs and 3 QUANTIZEs; the .tflite graphs with a
    QUANTIZE have 2 to 4."""
    g = GRAPHS[graph]()
    plan = perop.PerOpPlan(g, bits)
    rng = np.random.default_rng(11)
    kinds = []
    for k, st in enumerate(plan.stages):
        if perop.card_kernel(st) not in ROUTES:
            continue
        kinds.append(st.kernel)
        desc = getattr(plan, f"descs{k}")
        for off in (0, 1):
            xs = []
            for i in st.inputs:
                shape = (3,) + st.shapes[i]
                buf = torch.from_numpy(rng.integers(
                    -128, 128, off + int(np.prod(shape))).astype(np.int8))
                xs.append(buf[off:].view(shape))
            want = torch.empty((3,) + st.shapes[st.outputs[0]],
                               dtype=torch.int8)
            perop.perop_plain(st, torch.from_numpy(st.consts), xs + [want])
            assert torch.equal(_wrapper(st, desc, xs), want), (k, st.kernel)
            out = torch.full_like(want, 7)
            assert _wrapper(st, desc, xs, out) is out
            assert torch.equal(out, want), (k, st.kernel)
    counts = {name: kinds.count(name) for name in ("add_int8",
                                                   "requantize_int8")}
    ops = [op.opname for op in g.ops]
    assert counts == {"add_int8": ops.count("ADD"),
                      "requantize_int8": ops.count("QUANTIZE")}
    if graph == "corpus":
        assert counts == {"add_int8": 3, "requantize_int8": 3}


def _self_add_graph():
    """x + x: one int8 [N,5,6,7] input, both ADD operands."""
    b = TOOL.GraphMaker(3)
    x = b.tensor((1, 5, 6, 7), scale=0.05, zp=-3)
    b.op("ADD", [x, x], b.tensor((1, 5, 6, 7), scale=0.09, zp=4))
    return b.graph([x], [1])


@pytest.mark.parametrize("bits", perop.BITS)
def test_self_add(bits):
    """x + x plans one input that both views name; the wrapper takes it
    twice and equals the program's plain executor and JAX ``add_int8``."""
    g = _self_add_graph()
    (st,) = perop.build_perop_plan(g, bits)
    assert st.inputs == [0] and perop.card_kernel(st) == perop.ADD_KERNEL
    assert st.descs[0, F["in0_space"]] == st.descs[0, F["in1_space"]] == 1
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -128, 128, (3, 5, 6, 7)).astype(np.int8))
    a, b = perop.add_inputs(st, [x])
    assert a is x and b is x
    want = torch.empty_like(x)
    perop.perop_plain(st, torch.from_numpy(st.consts), [x, want])
    got = eltwise.add_flat(torch.from_numpy(st.descs[0]), x, x)
    assert torch.equal(got, want)
    jg = TOOL.jax_graph(g)
    np.testing.assert_array_equal(
        got.numpy(), _jax(jg, jg.ops[0], bits, x.numpy(), x.numpy()))
    assert len(np.unique(got.numpy())) > 2


def _descs(bits="fast"):
    """{B8 kernel: its first descriptor row} of the op-surface graph."""
    plan = perop.PerOpPlan(TOOL.surface_graph(), bits)
    got = {}
    for k, st in enumerate(plan.stages):
        got.setdefault(st.kernel, getattr(plan, f"descs{k}"))
    return got


def _x(*shape, off=0):
    return torch.zeros(off + int(np.prod(shape)), dtype=torch.int8)[
        off:].view(shape)


REFUSED = {
    "ADD kernel on a QUANTIZE": (lambda d: eltwise.add_flat(
        d["requantize_int8"], _x(1, 4, 4, 8), _x(1, 4, 4, 8)),
        "the ADD kernel takes ADD ops"),
    "ADD kernel on a LEAKY": (lambda d: eltwise.add_flat(
        d["leaky_int8"], _x(1, 4, 4, 8), _x(1, 4, 4, 8)),
        "the ADD kernel takes ADD ops"),
    "table kernel on an ADD": (lambda d: eltwise.eltwise_lut(
        d["add_int8"], _x(1, 4, 4, 8)), "ACT, LEAKY and QUANTIZE ops"),
    "unequal shapes": (lambda d: eltwise.add_flat(
        d["add_int8"], _x(1, 4, 4, 8), _x(1, 4, 8, 4)), "one shape"),
    "strided input": (lambda d: eltwise.add_flat(
        d["add_int8"], _x(1, 4, 4, 8), _x(1, 4, 8, 4).transpose(1, 2)),
        "contiguous"),
    "float input": (lambda d: eltwise.add_flat(
        d["add_int8"], _x(1, 4, 4, 8).float(), _x(1, 4, 4, 8)), "int8"),
    "descriptor on another device": (lambda d: eltwise.add_flat(
        d["add_int8"].to("meta"), _x(1, 4, 4, 8), _x(1, 4, 4, 8)),
        "desc on meta"),
    "inputs on another device": (lambda d: eltwise.add_flat(
        d["add_int8"].to("meta"), _x(1, 4, 4, 8).to("meta"),
        _x(1, 4, 4, 8).to("meta")), "no elementwise kernel"),
    "out on an input": (lambda d: (lambda a: eltwise.add_flat(
        d["add_int8"], a, _x(1, 4, 4, 8), out=a))(_x(1, 4, 4, 8)),
        "share storage"),
    "out of another shape": (lambda d: eltwise.add_flat(
        d["add_int8"], _x(1, 4, 4, 8), _x(1, 4, 4, 8), out=_x(1, 4, 8, 4)),
        "tensor like x"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrappers_refuse(case):
    call, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        call(_descs())


@pytest.mark.parametrize("mode", sorted(PEROP_BITS))
def test_cpu_engine_outputs_unchanged(mode):
    """``Int8Engine(surface, mode, device="cpu")`` and the corpus engine
    still give the golden keys, with no launch of either flat kernel."""
    gold = np.load(GOLDEN)
    bits = PEROP_BITS[mode]
    eltwise.eltwise_lut.launches = eltwise.add_flat.launches = 0
    ys = Int8Engine(TOOL.surface_graph(), mode, device="cpu")(
        torch.from_numpy(TOOL.surface_frames()))
    for k, y in enumerate(ys):
        np.testing.assert_array_equal(y.numpy(), gold[f"surface_{bits}{k}"])
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    pipe = load_pipeline(CORPUS, mode=mode, device="cpu")
    y = pipe.engine(pipe.preprocess(torch.from_numpy(gold["frames"])))
    np.testing.assert_array_equal(
        y.numpy(), gold["head_exact" if bits == "exact" else "head_fast"])
    assert eltwise.eltwise_lut.launches == eltwise.add_flat.launches == 0
