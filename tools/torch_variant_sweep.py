#!/usr/bin/env python3
"""Time variants of two byte-move kernels on a CUDA card: the choices
``PERF.md`` §6 records for ``csrc/probe_copy.cu`` (threads a block
x 16-byte loads a thread has in flight) and ``csrc/pad_int8.cu`` (a border
chunk merged from two shared-memory windows or gathered element by
element; a launch bound of six blocks an SM).

Usage (on the card, from the repository root)::

    python3 tools/torch_variant_sweep.py [copy] [pad]

Each variant is a copy of the kernel's source with one constant or
condition rewritten, built with the library's ``nvcc`` flags into
``build/yoloface_tpu_torch/sweep/`` and loaded beside the library.  Every
variant is held bit for bit against the plain version on the input it is
timed on (a mismatch raises), then timed as the repository times the
kernel: the per-frame copy as a call in a chain of 20 (B9.10's method,
beside ``Tensor.clone``), each corpus PAD at batch 16384 in device time
behind a spin (beside ``F.pad``).  Imports no jax.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from yoloface_tpu_torch.io.tflite_import import load_tflite  # noqa: E402
from yoloface_tpu_torch.kernels import _build, move, perop  # noqa: E402
from yoloface_tpu_torch.probes import (  # noqa: E402
    same, time_chain, time_ms)

CORPUS = os.path.join(ROOT, "checkpoints", "yoloface_corpus_int8.tflite")
THREADS = "constexpr int kCopyThreads = 512;"
IN_FLIGHT = "constexpr int kCopyInFlight = 4;"
MERGE = "} else if (kV >= 8 && row_e >= kV) {"
BOUND = "__launch_bounds__(kMoveThreads)\n    pad_kernel"
# (name, source, C entry, substitutions): each substitution must match once
COPY_VARIANTS = [
    (f"{t} threads x {k}", "probe_copy.cu", "yf_probe_copy",
     [(THREADS, f"constexpr int kCopyThreads = {t};"),
      (IN_FLIGHT, f"constexpr int kCopyInFlight = {k};")])
    for t in (256, 512) for k in (1, 4, 8)]
PAD_VARIANTS = [
    ("as built", "pad_int8.cu", "yf_pad_int8", []),
    ("border chunks gathered (any C)", "pad_int8.cu", "yf_pad_int8",
     [(MERGE, "} else if (kV >= 32 && row_e >= kV) {")]),
    ("border chunks merged (any C)", "pad_int8.cu", "yf_pad_int8",
     [(MERGE, "} else if (kV >= 2 && row_e >= kV) {")]),
    ("launch bound 6 blocks an SM", "pad_int8.cu", "yf_pad_int8",
     [(BOUND, "__launch_bounds__(kMoveThreads, 6)\n    pad_kernel")]),
]


def build_variant(k: int, source: str, entry: str, subs) -> object:
    """The C entry of ``source`` with ``subs`` applied, built and loaded."""
    text = (_build.CSRC / source).read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{source}: {old!r} found {text.count(old)} "
                               "times, not once")
        text = text.replace(old, new)
    name = f"{entry}_v{k}"
    text = text.replace(f'extern "C" int {entry}(', f'extern "C" int {name}(')
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-shared", "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def sweep_copy(dev) -> None:
    """The per-frame copy (one block a frame) of t73 and t99 at 128."""
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = {name: torch.randint(-128, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8)
          for name, shape in (("t73 [128,112,112,24]", (128, 112, 112, 24)),
                              ("t99 [128,56,56,32]", (128, 56, 56, 32)))}
    clone = {name: time_chain(torch.clone, x, 20, 5)
             for name, x in xs.items()}
    for k, (label, *spec) in enumerate(COPY_VARIANTS):
        fn = build_variant(k, *spec)
        line = []
        for name, x in xs.items():
            frame = x.numel() // x.shape[0]
            params = (ctypes.c_int * 6)(1, x.shape[0], 1, frame, frame, 1)

            def copy(v, params=params):
                out = torch.empty_like(v)
                _build.check(fn(v.data_ptr(), out.data_ptr(), params,
                                _stream(dev)), label)
                return out
            same(copy(x), x.clone(), f"copy {label} {name}")
            ms = time_chain(copy, x, 20, 5)
            line.append(f"{name} {ms:.4f} ms ({ms / clone[name]:.2f}x "
                        f"clone {clone[name]:.4f})")
        print(f"[sweep] per-frame copy, {label} in flight: "
              + "; ".join(line), flush=True)


def sweep_pad(dev) -> None:
    """The corpus net's three PADs at batch 16384."""
    plan = perop.PerOpPlan(load_tflite(CORPUS), "fast").to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-128, 128, (16384, 56, 56, 3), generator=gen,
                      device=dev, dtype=torch.int8)
    env = plan.run_stages(x)
    pads = [st for st in plan.stages if st.kernel == "pad_int8"]
    ins = [env[st.inputs[0]] for st in pads]
    outs = [torch.empty_like(env[st.outputs[0]]) for st in pads]
    lib = [time_ms(lambda st=st, a=a: move.pad_int8_plain(a, *st.args),
                   dev, 10) for st, a in zip(pads, ins)]
    print("[sweep] F.pad on the corpus PADs at 16384: "
          + ", ".join(f"{tuple(a.shape[1:])} {t:.4f}"
                      for a, t in zip(ins, lib))
          + f" ms; sum {sum(lib):.4f}", flush=True)
    for k, (label, *spec) in enumerate(PAD_VARIANTS):
        fn = build_variant(k, *spec)
        times = []
        for st, a, o in zip(pads, ins, outs):
            def pad(st=st, a=a, o=o):
                _build.check(fn(a.data_ptr(), o.data_ptr(), *a.shape,
                                *st.args, _stream(dev)), label)
            o.zero_()
            pad()
            same(o, move.pad_int8_plain(a, *st.args), f"pad {label}")
            times.append(time_ms(pad, dev, 10))
        print(f"[sweep] pad_int8, {label}: "
              + ", ".join(f"{tuple(a.shape[1:])} {t:.4f}"
                          for a, t in zip(ins, times))
              + f" ms; sum {sum(times):.4f}", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_variant_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"[sweep] {card}; torch {torch.__version__}", flush=True)
    _build.library()
    sweeps = {"copy": sweep_copy, "pad": sweep_pad}
    for name in argv or list(sweeps):
        sweeps[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
