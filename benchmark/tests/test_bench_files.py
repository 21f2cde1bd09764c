"""``BENCHMARK.json`` against the rules its file keeps, and every name in
it found as a file."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert _line(c["source"]) and _line(c["why"])
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        # the file states what BENCHMARK.json says of it, and holds every
        # key that it lists as changed
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
        # its program, graph reader and data are found by name
        assert (ROOT / "benchmark" / "programs" /
                f"{cfg['program']}.py").is_file()
        assert (ROOT / "benchmark" / "graphs" /
                f"{cfg['graph']['kind']}.py").is_file()
        assert cfg["graph"]["file"].startswith("benchmark/")
        assert (ROOT / cfg["graph"]["file"]).is_file()


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert _line(w["why"])
        path = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        with open(path) as f:
            traffic = json.load(f)
        assert (ROOT / "benchmark" / "frames" /
                f"{traffic['frames']}.py").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in bench["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in bench["per_layer"])
        # a whole-step share of the peak beside the kernels' rooflines
        assert any("mfu" in m["name"] for m in bench["per_layer"] if has(m))


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
