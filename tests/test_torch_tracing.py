"""The port's own tracing (``yoloface_tpu_torch/runtime/profiler.py``) on the
CPU: the op kinds the stage kernels' cycle counters are summed by, the
``FacePipeline`` layer spans, and the gate that keeps both off outside a
``torch.profiler`` session.  The traced kernels themselves run only on a
card (``tests/test_torch_gpu.py -k traced``)."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import profile

from yoloface_tpu_torch.kernels import arena, tiled
from yoloface_tpu_torch.pipeline.e2e import load_pipeline
from yoloface_tpu_torch.runtime import profiler

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
# every op code of kernels/arena.py and the kind its cycles count under
CODE_KINDS = {"COPY": "byteops", "CONV": "conv", "DW": "dw",
              "MAXPOOL": "pool", "ADD": "byteops", "QUANTIZE": "byteops",
              "PAD": "byteops", "LEAKY": "byteops", "ACT": "byteops",
              "RESIZE": "byteops", "AVGPOOL": "pool"}
SPANS = ["yf.preprocess", "yf.net", "yf.head"]


@pytest.fixture(scope="module")
def pipe():
    return load_pipeline(CORPUS, mode="arena2", device="cpu")


def _entry(pipe, entry):
    """(the entry, one frame of its input)."""
    f = torch.from_numpy(np.load(GOLDEN)["frames"][:1])
    if entry == "detect_int8_device":
        return pipe.detect_int8_device, pipe.preprocess(f)
    return pipe.detect_rgb565_device, f


def test_op_codes_are_the_kinds_codes():
    """The kinds hold every op code of the stage programs, none twice."""
    codes = sorted(c for of in arena.OP_KINDS.values() for c in of)
    assert codes == sorted(getattr(arena, n) for n in CODE_KINDS)


@pytest.mark.parametrize("name", sorted(CODE_KINDS))
def test_each_op_code_has_one_kind(name):
    code = getattr(arena, name)
    kinds = [k for k, of in arena.OP_KINDS.items() if code in of]
    assert kinds == [CODE_KINDS[name]]


@pytest.mark.parametrize("entry", ["detect_rgb565_device",
                                   "detect_int8_device"])
def test_spans_name_the_layers_in_order(pipe, entry):
    """Under a ``torch.profiler`` session each device entry emits the
    preprocess, net and head spans as user annotations, in that order."""
    fn, x = _entry(pipe, entry)
    with profile() as prof:
        fn(x)
    got = sorted((e.time_range.start, e.name) for e in prof.events()
                 if e.name.startswith("yf."))
    assert [name for _, name in got] == SPANS


@pytest.mark.parametrize("entry", ["detect_rgb565_device",
                                   "detect_int8_device"])
def test_spans_enter_no_record_function_without_a_session(pipe, entry,
                                                           monkeypatch):
    calls = []

    class Counted:
        def __init__(self, name):
            calls.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    fn, x = _entry(pipe, entry)
    assert not profiler.enabled()
    fn(x)
    assert calls == []
    with profile():
        assert profiler.enabled()
        fn(x)
    assert calls == SPANS
    assert not profiler.enabled()


def test_stage_cycles_is_empty_on_the_cpu(pipe):
    """A CPU forward under a session takes the plain versions: no traced
    launch, no counter, an empty split."""
    before = (arena.arena_stage.traced_launches,
              tiled.tiled_section.traced_launches)
    fn, x = _entry(pipe, "detect_rgb565_device")
    with profile():
        fn(x)
    assert profiler.stage_cycles() == []
    assert all(getattr(st, "op_cycles", None) is None
               for st in pipe.engine.arena.stages)
    assert (arena.arena_stage.traced_launches,
            tiled.tiled_section.traced_launches) == before
    profiler.reset_counters()
    assert profiler.stage_cycles() == []


def test_counters_are_no_module_state():
    """A stage's counter is a plain attribute, allocated once: the plan's
    ``state_dict`` keeps its descriptors and constants and nothing else."""
    plan = load_pipeline(CORPUS, mode="arena2", device="cpu").engine.arena
    keys = set(plan.state_dict())
    st = plan.stages[0]
    buf = profiler.op_cycles(st, "arena_stage_kernel", torch.device("cpu"))
    assert buf.dtype == torch.int64 and buf.shape == (len(st.descs),)
    assert not buf.any()
    assert profiler.op_cycles(st, "arena_stage_kernel",
                              torch.device("cpu")) is buf
    assert set(plan.state_dict()) == keys
