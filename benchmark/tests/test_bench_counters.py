"""The net's per-kind readers (``metrics/net_*_ms.py``,
``harness/net_kinds.py``) on a synthetic trace and synthetic counters: two
stages of different kind mixes, two batches."""

import pytest

from benchmark.harness import named, net_kinds, trace
from benchmark.harness.cell import Context

KINDS = ("conv", "dw", "pool", "byteops")
SECTION = ("void (anonymous namespace)::tiled_section_kernel<false, false, "
           "true>(yf::StripOp const*, int)")
ARENA = ("void (anonymous namespace)::arena_stage_kernel<false, true>"
         "(yf::Op const*, int)")
HEAD = "(anonymous namespace)::detect_head_block_kernel(signed char const*)"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _stages(second="tiled_section_kernel"):
    """Stage 0: conv 3, dw 1 (cycles); stage 1: pool 1, byteops 1."""
    return [{"kernel": "tiled_section_kernel",
             "kinds": {"conv": 300, "dw": 100, "pool": 0, "byteops": 0},
             "ops": [300, 100]},
            {"kernel": second,
             "kinds": {"conv": 0, "dw": 0, "pool": 5000, "byteops": 5000},
             "ops": [5000, 5000]}]


def _ctx(kernels=(SECTION, SECTION, SECTION, SECTION)):
    """Two batches of 4 frames: stage 0 runs 100 and 120 us, stage 1 40 and
    60 us; a head kernel after each batch."""
    durs = (100.0, 40.0, 120.0, 60.0)
    events = [_x("user_annotation", "bench.window", 0.0, 1000.0)]
    t = 10.0
    for k, (name, d) in enumerate(zip(kernels, durs)):
        events.append(_x("kernel", name, t, d))
        t += d
        if k % 2:
            events.append(_x("kernel", HEAD, t, 5.0))
            t += 5.0
    return Context(trace=trace.Trace(events), frames_traced=8,
                   batches=[(0.0, 0.5, 4), (0.1, 0.6, 4)])


def _read(ctx):
    return {k: named.module("metrics", f"net_{k}_ms").read(ctx)
            for k in KINDS}


def test_each_stage_splits_its_own_time(monkeypatch):
    monkeypatch.setattr(net_kinds, "_stage_cycles", _stages)
    got = _read(_ctx())
    # stage 0: 220 us as 3:1, stage 1: 100 us as 1:1, over 2 batches
    assert got["conv"] == pytest.approx(220 * 0.75 / 2 * 1e-3)
    assert got["dw"] == pytest.approx(220 * 0.25 / 2 * 1e-3)
    assert got["pool"] == pytest.approx(100 * 0.5 / 2 * 1e-3)
    assert got["byteops"] == pytest.approx(100 * 0.5 / 2 * 1e-3)


def test_the_kinds_add_up_to_the_net(monkeypatch):
    monkeypatch.setattr(net_kinds, "_stage_cycles", _stages)
    ctx = _ctx()
    net_ms_a_batch = ctx.trace.layer_s("net") * 1e3 / 2
    assert sum(_read(ctx).values()) == pytest.approx(net_ms_a_batch)


def test_a_name_mismatch_reads_nothing(monkeypatch):
    monkeypatch.setattr(net_kinds, "_stage_cycles",
                        lambda: _stages("arena_stage_kernel"))
    assert _read(_ctx()) == dict.fromkeys(KINDS)
    monkeypatch.setattr(net_kinds, "_stage_cycles", _stages)
    assert _read(_ctx((SECTION, ARENA, SECTION, SECTION))) == \
        dict.fromkeys(KINDS)


@pytest.mark.parametrize("stages", [[], _stages()[:1] * 3])
def test_no_counters_or_counts_that_do_not_divide_read_nothing(monkeypatch,
                                                                stages):
    monkeypatch.setattr(net_kinds, "_stage_cycles", lambda: stages)
    assert _read(_ctx()) == dict.fromkeys(KINDS)


def test_a_stage_without_cycles_reads_nothing(monkeypatch):
    stages = _stages()
    stages[1]["kinds"] = dict.fromkeys(KINDS, 0)
    monkeypatch.setattr(net_kinds, "_stage_cycles", lambda: stages)
    assert _read(_ctx()) == dict.fromkeys(KINDS)


def test_the_port_on_the_cpu_reads_nothing():
    """The port's own ``stage_cycles`` on the CPU: no counters."""
    assert net_kinds._stage_cycles() == []
    assert _read(_ctx()) == dict.fromkeys(KINDS)
