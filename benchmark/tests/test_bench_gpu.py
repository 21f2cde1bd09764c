"""Each cell run whole on the card, briefly, traced: a result line with
`correct` true and every share of a roofline or of the peak within
(0, 100].  Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["face56.arena2.b65536", "face448.tiled2.b1024",
         "face56.arena_exact.b65536"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(cuda, name):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 17), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for k, m in out["metrics"].items():
        if k.endswith("_roofline") or "mfu" in k:
            assert 0 < m["value"] <= 100, (k, m)
    assert {"net_roofline", "mfu_int8", "device_idle_share"} <= set(
        out["metrics"])
