"""The port's profiler (``yoloface_tpu_torch/runtime/profiler.py``) against
the JAX package's (``yoloface_tpu/runtime/profiler.py``) on the CPU.

``macc_per_op`` equals JAX's exactly on the corpus net (1,029,000 MACCs a
frame), the fuzz graphs, the v3-tiny FPN and the 448 retarget (65,856,000);
``profile_engine``'s rows cover every op of the graph once and their MACCs
add up to that total in the plain and the kernel modes (the kernel modes'
plain versions here); in ``exact`` its rows are JAX's, op for op;
``format_profile`` is JAX's; ``trace`` writes a Chrome trace."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from yoloface_tpu.graph.retarget import retarget_spatial as jax_retarget
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.runtime import profiler as jprof
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch.graph.retarget import retarget_spatial
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.runtime import profiler
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load("make_torch_port_golden",
             os.path.join(REPO, "tools", "make_torch_port_golden.py"))
PATHS = {"corpus": CORPUS, **{name: TOOL.tflite_path(name)
                              for name in TOOL.TFLITE_GRAPHS}}
# the MACCs a frame the X-CUBE-AI report's conv ops add up to, and the
# retarget's 8 x 8 of them
TOTALS = {"corpus": 1_029_000, "corpus448": 65_856_000}
JAX_KEYS = {"op_index", "op", "out_tensor", "ms", "macc_per_frame"}


def _graphs(name):
    """(the port's graph, JAX's graph) of ``name``."""
    path = PATHS[name.replace("448", "")]
    g, jg = load_tflite(path), jax_load_tflite(path)
    if name.endswith("448"):
        return retarget_spatial(g, 8), jax_retarget(jg, 8)
    return g, jg


@pytest.mark.parametrize("name", [*PATHS, "corpus448"])
def test_macc_per_op_equals_jax(name):
    g, jg = _graphs(name)
    got = profiler.macc_per_op(g)
    assert got == jprof.macc_per_op(jg)
    assert all(type(v) is int for v in got.values())
    if name in TOTALS:
        assert sum(got.values()) == TOTALS[name]
    assert sum(got.values()) > 0


def _frames(g, n, seed=3):
    shape = g.tensor(g.inputs[0]).shape[1:]
    return np.random.default_rng(seed).integers(
        -128, 128, (n, *shape)).astype(np.int8)


@pytest.mark.parametrize("mode", ["exact", "fast", "fast2", "arena2",
                                  "arena_exact", "fused", "fused_exact",
                                  "perop", "perop_exact", "tiled2"])
def test_profile_rows_cover_every_op_once(mode):
    """One row a unit the mode launches (a lowered op, or a stage /
    one-op program), every op of the graph in exactly one row, the rows'
    MACCs adding up to ``macc_per_op``'s total, JAX's keys, sorted by
    time."""
    g = load_tflite(CORPUS)
    eng = Int8Engine(g, mode, device="cpu")
    rows = profiler.profile_engine(eng, _frames(g, 2), iters=1, warmup=0)
    units = (eng.arena.stages if hasattr(eng, "arena") else eng._plan)
    assert len(rows) == len(units)
    assert all(JAX_KEYS <= set(r) and r["ms"] >= 0 for r in rows)
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows),
                                             reverse=True)
    ops = [int(o.split(":")[1]) for r in rows for o in r["ops"]]
    assert sorted(ops) == [op.index for op in g.ops]
    assert sum(r["macc_per_frame"] for r in rows) == TOTALS["corpus"]
    maccs = profiler.macc_per_op(g)
    for r in rows:
        assert r["macc_per_frame"] == sum(
            maccs[int(o.split(":")[1])] for o in r["ops"])
        assert r["op_index"] == int(r["ops"][0].split(":")[1])
    if mode == "fast2":     # a conv and the LEAKY it fuses are one unit
        assert any(r["op"] in ("CONV_2D+LEAKY_RELU",
                               "DEPTHWISE_CONV_2D+LEAKY_RELU") for r in rows)


def test_exact_rows_are_jax_rows():
    """In ``exact`` every lowered op is a unit, as in JAX's ``exact``: the
    rows name the same ops, output tensors and MACCs."""
    g, jg = _graphs("corpus")
    x = _frames(g, 1)

    def key(rows):
        return sorted((r["op_index"], r["op"], r["out_tensor"],
                       r["macc_per_frame"]) for r in rows)
    got = profiler.profile_engine(Int8Engine(g, "exact", device="cpu"), x,
                                  iters=1, warmup=0)
    want = jprof.profile_engine(JaxEngine(jg, "exact"), x, iters=1, warmup=0)
    assert key(got) == key(want)
    assert len(got) == len(g.ops)


def test_format_profile_is_jax_format():
    g = load_tflite(CORPUS)
    rows = profiler.profile_engine(Int8Engine(g, "fast2", device="cpu"),
                                   _frames(g, 1), iters=1, warmup=0)
    table = profiler.format_profile(rows)
    assert table == jprof.format_profile(rows)
    assert "MACC" in table and "CONV_2D+LEAKY_RELU" in table
    assert table.splitlines()[-1].endswith(f"{TOTALS['corpus']} MACC/frame")


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` writes one new JSON file into the directory it is given,
    holding the events of the ops run inside it."""
    g = load_tflite(CORPUS)
    eng = Int8Engine(g, "arena2", device="cpu")
    with profiler.trace(str(tmp_path / "t")) as path:
        eng(_frames(g, 1))
    assert os.listdir(tmp_path / "t") == [os.path.basename(path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
