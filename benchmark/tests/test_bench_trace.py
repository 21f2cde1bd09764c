"""The trace reduction on synthetic profiler events: busy time, idle
gaps by host activity, layer times, the top device operations."""

import pytest

from benchmark.harness import trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    return [
        _x("user_annotation", "bench.window", 0.0, 1000.0),
        _x("user_annotation", "bench.submit", 10.0, 20.0),
        _x("cpu_op", "aten::empty", 12.0, 2.0),
        _x("user_annotation", "bench.wait", 40.0, 500.0),
        _x("kernel", "void (anonymous namespace)::arena_stage_kernel<false>"
           "(yf::Op const*)", 50.0, 400.0),
        _x("kernel", "(anonymous namespace)::preprocess_rgb565_kernel(int)",
           30.0, 20.0),
        _x("kernel", "(anonymous namespace)::detect_head_kernel(int)",
           600.0, 100.0),
        _x("kernel", "void at::native::reduce_kernel<512>(int)", 690.0,
           20.0),
        _x("gpu_memcpy", "Memcpy DtoH", 900.0, 50.0),
        # outside the window: left out
        _x("kernel", "void (anonymous namespace)::arena_stage_kernel<false>"
           "(yf::Op const*)", 2000.0, 400.0),
    ]


def test_busy_and_window():
    t = trace.Trace(_events())
    assert t.window_s == pytest.approx(1000e-6)
    # [30, 450], [600, 710], [900, 950]
    assert t.busy_s == pytest.approx((420 + 110 + 50) * 1e-6)


def test_layer_seconds():
    t = trace.Trace(_events())
    assert t.layer_s("net") == pytest.approx(400e-6)
    assert t.layer_s("preprocess") == pytest.approx(20e-6)
    assert t.layer_s("head") == pytest.approx(100e-6)
    assert t.layer_s("torch") == pytest.approx(20e-6)


def test_idle_gaps_by_host_activity():
    t = trace.Trace(_events())
    gaps = dict(t.idle_gaps())
    # [0, 30) begins outside any span, [450, 600) in bench.wait,
    # [710, 900) and [950, 1000) outside any span
    assert gaps["bench.wait"] == pytest.approx(150e-6)
    assert gaps["outside any span"] == pytest.approx((30 + 190 + 50) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_device_ops_by_short_name():
    ops = dict(trace.Trace(_events()).device_ops())
    assert ops["arena_stage_kernel<false>"] == pytest.approx(400e-6)
    assert ops["gpu_memcpy"] == pytest.approx(50e-6)
    assert len(trace.Trace(_events()).device_ops(top=2)) == 2


def test_no_window_span_is_an_error():
    with pytest.raises(RuntimeError):
        trace.Trace(_events()[1:])
