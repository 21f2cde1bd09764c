"""The port's ``ai_network_*`` facade (``yoloface_tpu_torch/runtime/api.py``)
against the JAX package's (``yoloface_tpu/runtime/api.py``) on the CPU.

Exactly: on the corpus ``.tflite`` the outputs, the return values, the
error pairs and ``n_batches``; the error pairs for a missing file, a wrong
input shape, a run before init and after destroy; the report's keys and
values (its ``mode`` string aside: each package names its own modes); and
on the two-output v3-tiny FPN the same return value and error pair as
JAX's."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yoloface_tpu.runtime import api as japi
from yoloface_tpu_torch.runtime import api
from yoloface_tpu_torch.runtime.engine import MODES

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
MISSING = os.path.join(REPO, "checkpoints", "no_such_graph.tflite")
# the port's mode: the JAX mode of the same bits
TWINS = {"exact": "exact", "fast2": "fast2", "arena2": "fast2",
         "perop": "fast"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load("make_torch_port_golden",
             os.path.join(REPO, "tools", "make_torch_port_golden.py"))


def _frames(n, hw=56, seed=9):
    return np.random.default_rng(seed).integers(
        -128, 128, (n, hw, hw, 3)).astype(np.int8)


def _both(mode, path=CORPUS):
    """(the port's network, JAX's), each initialised on ``path``."""
    net, jnet = api.ai_network_create(), japi.ai_network_create()
    assert api.ai_network_init(net, path, mode=mode, device="cpu")
    assert japi.ai_network_init(jnet, path, mode=TWINS[mode])
    return net, jnet


@pytest.mark.parametrize("mode", ["exact", "fast2", "arena2"])
def test_lifecycle_equals_jax(mode):
    """Two runs (into ``out_data`` and without it) give JAX's outputs,
    return values, error pairs and batch counts; the report is JAX's; a
    destroyed network reports itself uninitialised."""
    net, jnet = _both(mode)
    assert api.ai_network_get_error(net) == api.AI_ERROR_NONE
    x = _frames(2)
    out, jout = (np.empty((2, 7, 7, 18), np.int8) for _ in range(2))
    assert api.ai_network_run(net, x, out) == japi.ai_network_run(
        jnet, x, jout) == 2
    np.testing.assert_array_equal(out, jout)
    assert api.ai_network_run(net, _frames(3, seed=1)) == japi.ai_network_run(
        jnet, _frames(3, seed=1)) == 3
    assert api.ai_network_get_error(net) == japi.ai_network_get_error(
        jnet) == api.AI_ERROR_NONE
    assert net.n_batches == jnet.n_batches == 5
    report, jreport = (api.ai_network_get_report(net),
                       japi.ai_network_get_report(jnet))
    assert report.pop("mode") == mode and jreport.pop("mode") == TWINS[mode]
    assert report == jreport
    assert report["macc_per_frame_conv"] == 1_029_000
    assert report["input_shape"] == [1, 56, 56, 3]
    assert report["output_shape"] == [1, 7, 7, 18]
    api.ai_network_destroy(net)
    japi.ai_network_destroy(jnet)
    assert api.ai_network_get_report(net) == japi.ai_network_get_report(
        jnet) == {"initialized": False}
    assert api.ai_network_get_error(net) == api.AI_ERROR_NONE


CASES = {   # name: what to do to a fresh network (module, its init, net)
    "run before init": lambda m, init, net: m.ai_network_run(net,
                                                             _frames(1)),
    "missing file": lambda m, init, net: init(net, MISSING),
    "wrong input shape": lambda m, init, net: (
        init(net, CORPUS),
        m.ai_network_run(net, np.zeros((56, 56, 3), np.int8))),
    "wrong frame size": lambda m, init, net: (
        init(net, CORPUS), m.ai_network_run(net, _frames(1, 32))),
    "run after destroy": lambda m, init, net: (
        init(net, CORPUS), m.ai_network_destroy(net),
        m.ai_network_run(net, _frames(1))),
    "two-output graph": lambda m, init, net: (
        init(net, TOOL.tflite_path("v3tiny_fpn")),
        m.ai_network_run(net, TOOL.tflite_frames("v3tiny_fpn"))),
}
WANT = {"run before init": api.AI_ERROR_INIT_FAILED,
        "missing file": api.AI_ERROR_INIT_FAILED,
        "wrong input shape": api.AI_ERROR_INVALID_INPUT,
        "wrong frame size": api.AI_ERROR_INVALID_INPUT,
        "run after destroy": api.AI_ERROR_INIT_FAILED,
        "two-output graph": api.AI_ERROR_INVALID_INPUT}


@pytest.mark.parametrize("case", sorted(CASES))
def test_error_pairs_equal_jax(case):
    """Each case returns what JAX's returns and records JAX's error pair,
    raising nothing; on the FPN (two outputs of different shapes) both
    facades refuse the run as an invalid input."""
    net, jnet = api.ai_network_create(), japi.ai_network_create()
    got = CASES[case](api, lambda net, w: api.ai_network_init(
        net, w, device="cpu"), net)
    want = CASES[case](japi, japi.ai_network_init, jnet)
    assert got == want
    assert api.ai_network_get_error(net) == japi.ai_network_get_error(
        jnet) == WANT[case]
    assert net.n_batches == jnet.n_batches == 0


def test_init_takes_the_card_by_default():
    """``ai_network_init`` builds its engine on the card unless told
    otherwise: without a card it records INIT_FAILED, with one it runs
    there."""
    net = api.ai_network_create()
    ok = api.ai_network_init(net, CORPUS, mode="arena2")
    assert ok == torch.cuda.is_available()
    if ok:
        assert next(net.engine.buffers()).device.type == "cuda"
    else:
        assert api.ai_network_get_error(net) == api.AI_ERROR_INIT_FAILED
        assert net.engine is None


def test_every_port_mode_initialises():
    """The facade takes the port's own mode names and refuses another."""
    for mode in MODES:
        net = api.ai_network_create()
        assert api.ai_network_init(net, CORPUS, mode=mode, device="cpu"), mode
        assert api.ai_network_get_report(net)["mode"] == mode
    net = api.ai_network_create()
    assert not api.ai_network_init(net, CORPUS, mode="pallas_mxu2",
                                   device="cpu")
    assert api.ai_network_get_error(net) == api.AI_ERROR_INIT_FAILED


def test_perop_run_equals_jax_fast():
    """A kernel mode through the facade (``perop``, its plain version on
    the CPU) equals JAX's ``fast`` (the bits of ``pallas``) through JAX's
    facade."""
    net, jnet = _both("perop")
    x = _frames(2, seed=4)
    assert api.ai_network_run(net, x) == japi.ai_network_run(jnet, x) == 2
    out = np.empty((2, 7, 7, 18), np.int8)
    jout = np.empty_like(out)
    api.ai_network_run(net, x, out)
    japi.ai_network_run(jnet, x, jout)
    np.testing.assert_array_equal(out, jout)
