"""The control and the faults come out as not correct.

The control is the reference in the precision below the configuration's
int8, its weights on the int4 grid, put in the program's place; for the
exact cell also the program's own float32-requant mode.  The faults are
planted in the program underneath a run that is otherwise whole (the
harness's look for a card skipped, a small batch on the CPU): half of
the batch left out and the rest's answers given for it, and an answer
altered where it is produced.  On the card the same readings come from
``benchmark/readings.py`` at the cells' own sizes.
"""

import time

import pytest
import torch

from benchmark import readings
from benchmark.harness import check, cell

CELLS = [("face56.arena2.b65536", 16), ("face56.arena_exact.b65536", 16),
         ("face448.tiled2.b1024", 1)]


@pytest.mark.parametrize("name,batch", CELLS)
def test_control_fails(name, batch):
    s = cell.spec(name)
    rows = list(readings.readings(s, [], [5, 6, 7], 0.5, "cpu",
                                  batch=batch))
    assert len(rows) == 3
    for r in rows:
        correct, checks = check.judge(r["values"], s["config"]["limits"])
        assert not correct, checks


def test_program_control_fails_the_exact_cell():
    s = cell.spec("face56.arena_exact.b65536")
    rows = list(readings.readings(s, [], [5, 6, 7], 0.5, "cpu",
                                  program_control="arena2", batch=64))
    prog = [r for r in rows if r["kind"] == "control_arena2"]
    assert len(prog) == 3
    # the float32 requant path differs from the exact bits on some seed
    assert any(not check.judge(r["values"], s["config"]["limits"])[0]
               for r in prog)


def test_program_readings_pass():
    s = cell.spec("face56.arena2.b65536")
    rows = list(readings.readings(s, [1, 2], [], 3.0, "cpu", batch=16))
    assert [r["kind"] for r in rows] == ["program", "program"]
    for r in rows:
        assert check.judge(r["values"], s["config"]["limits"])[0]
    summ = readings.summary(rows)
    assert summ["head_bytes_differ"] == {"lower": 0, "upper": None}


def _run(monkeypatch, name, batch, seconds=3.0):
    monkeypatch.setattr(cell, "WARMUP_BATCHES", 1)
    return cell.run_cell(cell.spec(name), 123, seconds, False, "cpu",
                         time.perf_counter(), batch=batch)[0]


def _half_batch(monkeypatch):
    """The engine computes the first half of the batch and repeats its
    answers for the rest."""
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    forward = Int8Engine.forward

    def half(self, x):
        n = x.shape[0]
        y = forward(self, x[: (n + 1) // 2])
        return torch.cat([y, y])[:n]

    monkeypatch.setattr(Int8Engine, "forward", half)


def _altered_box(monkeypatch):
    """One box of each batch moved by a tenth of a pixel where the head
    produces it."""
    from yoloface_tpu_torch.pipeline.e2e import FacePipeline
    head = FacePipeline._head

    def altered(self, y):
        d = head(self, y)
        d["boxes"] = d["boxes"].clone()
        d["boxes"][0, 0, 0] += 0.1
        return d

    monkeypatch.setattr(FacePipeline, "_head", altered)


def _altered_head_byte(monkeypatch):
    """One int8 head value of each batch changed by one where the net
    produces it."""
    from yoloface_tpu_torch.runtime.engine import Int8Engine
    forward = Int8Engine.forward

    def altered(self, x):
        y = forward(self, x).clone()
        y.view(-1)[0] = y.view(-1)[0] ^ 1
        return y

    monkeypatch.setattr(Int8Engine, "forward", altered)


@pytest.mark.parametrize("fault", [_half_batch, _altered_box,
                                   _altered_head_byte])
@pytest.mark.parametrize("name,batch", [("face56.arena2.b65536", 16),
                                        ("face448.tiled2.b1024", 2)])
def test_a_fault_fails_the_run(monkeypatch, fault, name, batch):
    fault(monkeypatch)
    out = _run(monkeypatch, name, batch, 3.0 if batch > 2 else 6.0)
    assert out["correct"] is False, out


def test_the_same_run_unbroken_passes(monkeypatch):
    assert _run(monkeypatch, "face56.arena2.b65536", 16)["correct"] is True
