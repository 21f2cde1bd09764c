"""Environment verifier: ``python -m yoloface_tpu_torch.utils.verify_setup``.

The counterpart of ``yoloface_tpu.utils.verify_setup`` for the port: the
same check groups, colored PASS/FAIL lines and summary exit code, each
group checked for this environment (torch and CUDA, the card, the kernel
and native builds, the port's imports, the checkpoint, the float model
built and run on the card, an engine forward on the card, the checkpoint
directory).
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

GREEN, RED, YELLOW, END = "\033[92m", "\033[91m", "\033[93m", "\033[0m"

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKPOINT = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
# the modules a user calls, imported in a fresh interpreter that must not
# pull in jax (the card's machine has none)
MODULES = ("yoloface_tpu_torch.runtime.engine",
           "yoloface_tpu_torch.pipeline.e2e", "yoloface_tpu_torch.detect",
           "yoloface_tpu_torch.host.streamer",
           "yoloface_tpu_torch.host.monitor",
           "yoloface_tpu_torch.runtime.api",
           "yoloface_tpu_torch.kernels.arena",
           "yoloface_tpu_torch.train.trainer",
           "yoloface_tpu_torch.quantize.calibrate",
           "yoloface_tpu_torch.io.tflite_export")


def _report(name: str, ok: bool, detail: str = "") -> bool:
    mark = f"{GREEN}PASS{END}" if ok else f"{RED}FAIL{END}"
    print(f"  [{mark}] {name}" + (f" — {detail}" if detail else ""))
    return ok


def check_requirements() -> bool:
    print("Dependencies:")
    ok = True
    for mod, required in [("torch", True), ("numpy", True), ("cv2", False),
                          ("matplotlib", False)]:
        try:
            m = importlib.import_module(mod)
            _report(mod, True, getattr(m, "__version__", ""))
        except ImportError:
            if required:
                ok = _report(mod, False, "required") and ok
            else:
                print(f"  [{YELLOW}SKIP{END}] {mod} (optional)")
    return ok


def check_accelerator() -> bool:
    print("Accelerator:")
    import torch
    if not torch.cuda.is_available():
        return _report("CUDA card", False,
                       f"no CUDA card visible to torch {torch.__version__} "
                       f"(CUDA {torch.version.cuda})")
    _report("CUDA card", True,
            f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}, "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return _report("nvidia-smi", False, str(e)[:80])
    return _report("nvidia-smi", res.returncode == 0,
                   res.stdout.strip().splitlines()[0] if res.stdout.strip()
                   else res.stderr.strip()[:80])


def check_builds() -> bool:
    print("Builds:")
    from yoloface_tpu_torch.host import native
    from yoloface_tpu_torch.kernels import _build
    try:
        ok = _report("nvcc", True, _build._nvcc())
        lib = _build.library()
        ok = _report("CUDA kernels", lib is not None,
                     str(_build.build()).replace(REPO + os.sep, "")) and ok
    except (RuntimeError, OSError) as e:
        ok = _report("CUDA kernels", False, str(e).splitlines()[0][:80])
    nat = native.available()
    return _report("native frame pipeline", nat,
                   str(native.build()).replace(REPO + os.sep, "") if nat
                   else str(native.build_error).splitlines()[0][:80]) and ok


def check_framework_imports() -> bool:
    print("Framework imports:")
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'yoloface_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    detail = (res.stdout.strip() or res.stderr.strip()).splitlines()
    return _report(f"{len(MODULES)} modules, no jax", res.returncode == 0,
                   detail[-1][:80] if detail else "")


def check_artifacts() -> bool:
    print("Artifacts:")
    return _report("int8 tflite", os.path.exists(CHECKPOINT),
                   os.path.relpath(CHECKPOINT, REPO))


def check_model_init() -> bool:
    print("Model initialization:")
    try:
        import torch
        from yoloface_tpu_torch.core.precision import device_or_raise
        from yoloface_tpu_torch.models.yoloface import YoloFace, count_params
        model = YoloFace().to(device_or_raise("cuda", "YoloFace"))
        n = count_params(model)
        with torch.no_grad():
            y = model.eval()(torch.zeros(1, 56, 56, 3, device="cuda"))
        return _report("YoloFace init", n == 10214
                       and tuple(y.shape) == (1, 7, 7, 18),
                       f"{n} trainable params (expect 10214), output "
                       f"{tuple(y.shape)} on {y.device}")
    except Exception as e:   # any failure is this group's verdict
        return _report("YoloFace init", False, str(e)[:80])


def check_engine() -> bool:
    print("Inference engine:")
    try:
        import numpy as np
        from yoloface_tpu_torch.io.tflite_import import load_tflite
        from yoloface_tpu_torch.runtime.engine import Int8Engine
        eng = Int8Engine(load_tflite(CHECKPOINT), "arena_exact", "cuda")
        y = eng(np.zeros((1, 56, 56, 3), np.int8))
        return _report("engine forward on the card",
                       tuple(y.shape) == (1, 7, 7, 18)
                       and y.device.type == "cuda",
                       f"output {tuple(y.shape)} on {y.device}")
    except Exception as e:   # any failure is this group's verdict
        return _report("engine forward on the card", False, str(e)[:80])


def check_checkpoint_dirs(path: str = os.path.join(REPO, "checkpoints")
                          ) -> bool:
    print("Checkpoint directory:")
    try:
        os.makedirs(path, exist_ok=True)
        return _report("writable", os.access(path, os.W_OK),
                       os.path.relpath(path, REPO))
    except OSError as e:
        return _report("writable", False, str(e))


CHECKS = (check_requirements, check_accelerator, check_builds,
          check_framework_imports, check_artifacts, check_model_init,
          check_engine, check_checkpoint_dirs)


def main() -> int:
    results = [c() for c in CHECKS]
    passed = sum(results)
    print(f"\n{passed}/{len(results)} check groups passed")
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
