"""A run's last line, driven on the CPU at a small batch (the harness's
look for a card skipped), and the import check."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark.harness import cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [("face56.arena2.b65536", 8, 3.0),
         ("face56.arena_exact.b65536", 8, 3.0),
         ("face448.tiled2.b1024", 1, 6.0)]


@pytest.fixture
def quick(monkeypatch):
    """One warm-up batch: the CPU's runs are slow."""
    monkeypatch.setattr(cell, "WARMUP_BATCHES", 1)


def _run(name, batch, seconds, traced, seed=2**31 + 11):
    return cell.run_cell(cell.spec(name), seed, seconds, traced, "cpu",
                         time.perf_counter(), batch=batch)


def check_line(out, traced, s):
    """The result line's keys and types, ``checks`` last."""
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert isinstance(out["attempted"], int) and out["attempted"] > 0
    assert out["failed"] == 0
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"]: m["unit"] for m in
             cell.cell_metrics(s["bench"], s["cell"], kind)}
    for k, m in out["metrics"].items():
        assert names[k] == m["unit"] and isinstance(m["value"], float)
    d = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    if traced:
        assert {"busy_s", "window_s"} <= set(d)
        for lst in out["breakdown"].values():
            assert len(lst) <= 10
    assert isinstance(out["setup_build_s"], float)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("name,batch,seconds", CELLS)
def test_last_line(quick, name, batch, seconds):
    out, lines = _run(name, batch, seconds, False)
    check_line(out, False, cell.spec(name))
    assert out["correct"] is True
    assert set(out["metrics"]) == {"frames_per_s", "batch_ms_p95",
                                   "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    # the numbers compared close standard error
    assert lines[-len(out["checks"]):] == [
        f"check {k}: {c['value']} (limit {c['limit']})"
        for k, c in out["checks"].items()]
    # the set-up says what of it went into building the port's libraries
    assert lines[0].startswith("setup: ")


def test_traced_line(quick):
    name = "face56.arena2.b65536"
    out, _ = _run(name, 8, 3.0, True)
    check_line(out, True, cell.spec(name))
    assert out["correct"] is True
    # no device in a CPU run: the device's readers find nothing to read
    assert "net_roofline" not in out["metrics"]
    assert out["metrics"]["host_submit_ms"]["value"] > 0


def test_no_jax_after_the_entries_load():
    """Importing the harness, the reference and the port's modules that
    each cell's entry uses loads no module named jax or yoloface_tpu,
    compared by whole top-level names; the reference loads nothing of
    the port."""
    code = """
import sys, time
sys.path.insert(0, %r)
import benchmark.reference.net, benchmark.reference.head
import benchmark.reference.tflite, benchmark.reference.int8
assert not any(m.split('.')[0] == 'yoloface_tpu_torch' for m in sys.modules)
from benchmark.harness import cell
for name in ('face56.arena2.b65536', 'face56.arena_exact.b65536',
             'face448.tiled2.b1024'):
    s = cell.spec(name)
    cell.program_of(s['config'], s['traffic'], 'cpu')
assert any(m.split('.')[0] == 'yoloface_tpu_torch' for m in sys.modules)
print(cell.forbidden_modules())
""" % str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "yoloface_tpu_fake", sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "yoloface_tpu.sub", sys)
    assert cell.forbidden_modules() == ["yoloface_tpu"]


def test_run_refuses_without_a_card(tmp_path):
    """``run.py`` exits non-zero and prints no result without a card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "face56.arena2.b65536", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert res.returncode != 0 and res.stdout == ""
