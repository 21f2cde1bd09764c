"""The port's environment verifier (``python -m
yoloface_tpu_torch.utils.verify_setup``): the JAX package's check groups,
each for this environment, and its exit code.  On a machine without a
card it exits 1 and names the missing card; the groups that need no card
(dependencies, the port's imports without jax, the checkpoint, the
checkpoint directory, the native build where a compiler is) pass."""

import os
import subprocess
import sys

import pytest
import torch

from yoloface_tpu.utils import verify_setup as jverify
from yoloface_tpu_torch.host import native
from yoloface_tpu_torch.utils import verify_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_1_and_names_the_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present (tests/test_torch_gpu.py runs it)")
    res = subprocess.run([sys.executable, "-m",
                          "yoloface_tpu_torch.utils.verify_setup"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 1, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    card = [ln for ln in lines if "CUDA card" in ln]
    assert card and "FAIL" in card[0] and "no CUDA card" in card[0]
    engine = [ln for ln in lines if "engine forward on the card" in ln]
    assert engine and "FAIL" in engine[0] and "CUDA" in engine[0]
    assert lines[-1].endswith(f"/{len(verify_setup.CHECKS)} check groups "
                              "passed")


def test_the_groups_that_need_no_card_pass(tmp_path, capsys):
    assert verify_setup.check_requirements()
    assert verify_setup.check_framework_imports()
    assert verify_setup.check_artifacts()
    assert verify_setup.check_checkpoint_dirs(str(tmp_path / "ckpt"))
    assert os.path.isdir(tmp_path / "ckpt")
    out = capsys.readouterr().out
    assert "no jax" in out and "checkpoints/yoloface_corpus_int8.tflite" \
        in out


def test_card_groups_fail_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present (tests/test_torch_gpu.py runs it)")
    assert not verify_setup.check_accelerator()
    assert not verify_setup.check_model_init()
    assert not verify_setup.check_engine()
    ok = verify_setup.check_builds()
    out = capsys.readouterr().out
    assert not ok and "CUDA kernels" in out
    native_line = [ln for ln in out.splitlines() if "native" in ln][0]
    assert ("PASS" in native_line) == native.available()


def test_the_jax_package_s_groups_have_counterparts():
    """Every JAX group has a counterpart of its name (the float model's,
    ``check_model_init``, since the float model is ported); the port adds
    the kernel and native builds."""
    jax_groups = {n for n in dir(jverify) if n.startswith("check_")}
    port_groups = {c.__name__ for c in verify_setup.CHECKS}
    assert jax_groups - port_groups == set()
    assert port_groups - jax_groups == {"check_builds"}
