"""tools/torch_ab.py's reading of chip_smoke.py outputs, on the CPU."""

import ast
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(REPO, "tools", "torch_ab.py")


def _tool():
    spec = importlib.util.spec_from_file_location("torch_ab", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CARD = "(NVIDIA H100 80GB HBM3, 700.00 W)"


def _smoke(stage_ms, pipe_ms):
    """chip_smoke.py-like output around two timed figures."""
    return "\n".join([
        "[check] arena_stage fast2 bits N=1: every stage output bit-exact",
        f"[time] arena_stage fast2 N=16384: kernel {stage_ms} ms, plain "
        f"134.8997 ms {CARD}",
        f"[time] pipeline arena2 detect_rgb565_device N=65536: {pipe_ms} ms, "
        f"1402188 frames/s {CARD}",
        "[time] F.max_pool2d on maxpool_int8 op 5: none for int8 on this "
        "card",
        "[time] peak device memory 29.70 GiB",
        '{"ok": true}'])


def test_parse_times_takes_the_first_ms_of_each_timed_line():
    got = _tool().parse_times(_smoke("11.6479", "46.738"))
    assert got == {"arena_stage fast2 N=16384": 11.6479,
                   "pipeline arena2 detect_rgb565_device N=65536": 46.738}


def test_compare_means_each_trees_runs():
    tool = _tool()
    runs = {("parent", 1): tool.parse_times(_smoke("18.0", "70.0")),
            ("this", 1): tool.parse_times(_smoke("11.0", "46.0")),
            ("this", 2): tool.parse_times(_smoke("13.0", "48.0")),
            ("parent", 2): tool.parse_times(_smoke("20.0", "72.0"))}
    runs[("this", 2)]["only in one run"] = 1.0
    lines = tool.compare(runs)
    assert len(lines) == 2
    assert lines[0].startswith("[ab] arena_stage fast2 N=16384: parent "
                               "19.0000 ms (18.0000, 20.0000), this 12.0000 "
                               "ms (11.0000, 13.0000), -36.84%")
    assert lines[1].endswith("-33.80%")


@pytest.mark.parametrize("step", ["prepare", "run"])
def test_steps_parse_and_the_tool_imports_no_jax(step):
    tool = _tool()
    with pytest.raises(SystemExit) as e:
        tool.main([step, "--help"])
    assert e.value.code == 0
    with open(PATH) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "yoloface_tpu")]
