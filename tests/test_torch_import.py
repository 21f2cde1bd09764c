"""The port imports neither jax nor yoloface_tpu: the card's machine has no
jax, and any yoloface_tpu module imports jax (yoloface_tpu/__init__.py).
Nor flax, optax, orbax or flatbuffers, which the JAX package's training,
checkpointing and export use and the card's machine lacks."""

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
             if m.split('.')[0] in {BANNED})
print(len(names), bad)
assert not bad, bad
"""


_ENTRY = """
import sys
{imports}
bad = [m for m in sys.modules if m.split('.')[0] in {BANNED}]
assert not bad, bad
"""
BANNED = ("jax", "jaxlib", "yoloface_tpu", "flax", "optax", "orbax",
          "flatbuffers")
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
    "elementwise table kernel":
        "from yoloface_tpu_torch.kernels.eltwise import (eltwise_lut,\n"
        "                                               eltwise_lut_plain)",
    "flat ADD kernel":
        "from yoloface_tpu_torch.kernels.eltwise import (add_flat,\n"
        "                                               add_flat_plain)",
    "byte-move kernels":
        "from yoloface_tpu_torch.kernels.move import (concat_channels,\n"
        "                                            resize_nearest)",
    "host side":
        "from yoloface_tpu_torch.host import (gui, monitor, native, protocol,\n"
        "                                     streamer)",
    "detect CLI":
        "from yoloface_tpu_torch import detect",
    "verify setup":
        "from yoloface_tpu_torch.utils import verify_setup",
    "float model and training":
        "from yoloface_tpu_torch.models.yoloface import YoloFace\n"
        "from yoloface_tpu_torch.models.convert import state_dict_from_flax\n"
        "from yoloface_tpu_torch.train.steps import make_train_step\n"
        "from yoloface_tpu_torch.train.trainer import Trainer\n"
        "from yoloface_tpu_torch.train import __main__, data, evaluate",
    "calibration, float engine and export":
        "from yoloface_tpu_torch.quantize.calibrate import calibrate\n"
        "from yoloface_tpu_torch.models.import_weights import (\n"
        "    variables_from_template)\n"
        "from yoloface_tpu_torch.runtime.float_engine import FloatEngine\n"
        "from yoloface_tpu_torch.io.tflite_export import export_tflite\n"
        "from yoloface_tpu_torch.io.darknet import load_darknet_weights",
    "synthetic training example":
        "from yoloface_tpu_torch.examples import train_synthetic",
    "quantization-aware training":
        "from yoloface_tpu_torch.quantize import qat, qat_exact",
    "darknet-cfg family":
        "from yoloface_tpu_torch.io.darknet_cfg import (DarknetNet,\n"
        "                                               template_from_darknet)",
    "yolov3 trainer":
        "from yoloface_tpu_torch.train.yolov3 import (YoloV3Trainer,\n"
        "                                             make_v3_train_step)",
    "QAT and darknet examples":
        "from yoloface_tpu_torch.examples import train_darknet, train_qat",
    "probes entry points":
        "from yoloface_tpu_torch.kernels import probes\n"
        "from yoloface_tpu_torch.probes import (debug448, microbench,\n"
        "                                       probe448, probe448_micro)",
}


@pytest.mark.parametrize("entry", ["all modules", *ENTRIES])
def test_port_imports_without_jax(entry):
    code = (_CODE.replace("{BANNED}", repr(BANNED))
            if entry == "all modules" else
            _ENTRY.format(imports=ENTRIES[entry], BANNED=repr(BANNED)))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    if entry == "all modules":
        assert int(res.stdout.split()[0]) >= 47      # every module imported


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/torch_profile_pipeline.py",
                                    "tools/torch_variant_sweep.py"])
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
    assert not [m for m in names if m.split(".")[0] in BANNED]
