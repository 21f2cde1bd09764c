"""Run one cell of the port's benchmark on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, ``setup_build_s`` (the
seconds of ``setup_s`` that built the port's libraries: a checkout's first
run), and last ``checks``: each number compared with its limit, which also
close standard error.  Exits
non-zero, printing no result, without a CUDA card or if a module of JAX
or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode of torch, the port and the benchmark, cached inside the
# checkout: an installation that ships no .pyc files and sets
# PYTHONDONTWRITEBYTECODE compiles torch's modules anew in every process
# (7-11 s of each run's set-up on the card's machine)
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")
# fixed cache directories inside the checkout, so only a checkout's first
# run builds or compiles
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
sys.path.insert(0, str(ROOT))


def _power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it (None where
    it cannot)."""
    import subprocess
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(res.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell

    s = cell.spec(args.workload)
    chips = s["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, lines = cell.run_cell(s, args.seed, args.seconds, bool(args.trace),
                               "cuda:0", T_START)
    bad = cell.forbidden_modules()
    if bad:
        print(f"run.py: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    out["device"]["power_limit_w"] = _power_limit()
    print(f"device: {out['device']['kind']}, power limit "
          f"{out['device']['power_limit_w']} W", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
