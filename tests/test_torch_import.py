"""The port imports neither jax nor yoloface_tpu: the card's machine has no
jax, and any yoloface_tpu module imports jax (yoloface_tpu/__init__.py)."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, pkgutil, sys
import yoloface_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'yoloface_tpu'))
print(len(names), bad)
assert not bad, bad
"""


_ENTRY = """
import sys
{imports}
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'jaxlib', 'yoloface_tpu')]
assert not bad, bad
"""
ENTRIES = {
    "serving entry point":
        "from yoloface_tpu_torch.pipeline.e2e import load_pipeline",
    "448 entry point":
        "from yoloface_tpu_torch.graph.retarget import retarget_spatial\n"
        "from yoloface_tpu_torch.kernels.tiled import TiledPlan\n"
        "from yoloface_tpu_torch.runtime.engine import Int8Engine",
    "fused entry point":
        "from yoloface_tpu_torch.kernels.fused import FusedPlan\n"
        "from yoloface_tpu_torch.runtime.engine import FUSED_BITS",
    "per-op entry point":
        "from yoloface_tpu_torch.kernels.perop import PerOpPlan\n"
        "from yoloface_tpu_torch.runtime.engine import PEROP_BITS",
}


@pytest.mark.parametrize("entry", ["all modules", *ENTRIES])
def test_port_imports_without_jax(entry):
    code = (_CODE if entry == "all modules" else
            _ENTRY.format(imports=ENTRIES[entry]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    if entry == "all modules":
        assert int(res.stdout.split()[0]) >= 28      # every module imported


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/torch_profile_pipeline.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts the card's machine runs name no jax and no yoloface_tpu
    module in any import statement, at top level or inside a function."""
    import ast
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert any(m.startswith("yoloface_tpu_torch") for m in names)
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "yoloface_tpu")]
