#!/usr/bin/env python3
"""Time variants of kernels on a CUDA card: the choices ``PERF.md`` §6
records for ``csrc/probe_copy.cu`` (threads a block x 16-byte loads a
thread has in flight), ``csrc/pad_int8.cu`` (a border chunk merged from
two shared-memory windows or gathered element by element; a launch bound
of six blocks an SM), the tiled planner's ``MMA_MIN_K`` (which convs run
on the tensor cores, ``csrc/conv_mma.cuh``) and the tensor-core section
instantiation (n8 tiles a warp item, the order of its B loads, the blocks
an SM its launch bound asks for).

Usage (on the card, from the repository root)::

    python3 tools/torch_variant_sweep.py [copy] [pad] [mma] [mma_body]

Each variant is a copy of the kernel's source with one constant or
condition rewritten, built with the library's ``nvcc`` flags into
``build/yoloface_tpu_torch/sweep/`` and loaded beside the library.  Every
variant is held bit for bit against the plain version on the input it is
timed on (a mismatch raises), then timed as the repository times the
kernel: the per-frame copy as a call in a chain of 20 (B9.10's method,
beside ``Tensor.clone``), each corpus PAD at batch 16384 in device time
behind a spin (beside ``F.pad``).  The ``mma`` sweep plans yolov3-tiny at
416 (batch 256) and the 448 net (batch 1024) in ``tiled2`` at each
threshold and with no conv marked, holds each against the unmarked plan
bit for bit on 2 frames, and times the batch in device time.  Imports no
jax.
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
from yoloface_tpu_torch.graph.retarget import retarget_spatial  # noqa
from yoloface_tpu_torch.kernels import _build, move, perop, tiled  # noqa
from yoloface_tpu_torch.probes import (  # noqa: E402
    same, time_chain, time_ms)
from yoloface_tpu_torch.runtime.engine import Int8Engine  # noqa: E402

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


def variant_library(k: int, source: str, entry: str, subs):
    """``source`` with ``subs`` applied, built with ``-Xptxas -v`` into a
    directory of its own and loaded; a substitution ``(old, new)`` applies
    to ``source``, ``(header, old, new)`` to a header it includes (the
    variant's copy, found before the original).  -> (the library, the
    entry's name in it, the compiler's register and spill report)."""
    out = _build.BUILD_DIR / "sweep" / f"{entry}_v{k}"
    out.mkdir(parents=True, exist_ok=True)
    texts = {source: (_build.CSRC / source).read_text()}
    for sub in subs:
        file, old, new = sub if len(sub) == 3 else (source, *sub)
        text = texts.setdefault(file, (_build.CSRC / file).read_text())
        if text.count(old) != 1:
            raise RuntimeError(f"{file}: {old!r} found {text.count(old)} "
                               "times, not once")
        texts[file] = text.replace(old, new)
    name = f"{entry}_v{k}"
    texts[source] = texts[source].replace(f'extern "C" int {entry}(',
                                          f'extern "C" int {name}(')
    for file, text in texts.items():
        (out / file).write_text(text)
    so = out / f"{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-I", str(out), "-I", str(_build.CSRC),
                          "-shared", "-o", str(so), str(out / source)],
                         check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so)), name, res.stderr


def build_variant(k: int, source: str, entry: str, subs) -> object:
    """The C entry of ``source`` with ``subs`` applied, built and loaded."""
    lib, name, _ = variant_library(k, source, entry, subs)
    fn = getattr(lib, name)
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


# MMA_MIN_K candidates; None marks no conv (every conv on conv_op).  16
# marks every conv of ci >= 16 (the 448 net's two 1x1s of ci 32 and 48);
# 288 and 576 leave yolov3-tiny's layers 2 (K 144) and 4 (K 288) off
MMA_THRESHOLDS = (None, 16, 64, 288, 576)
NT = ("conv_mma.cuh", "constexpr int kMmaNt = 4;",
      "constexpr int kMmaNt = 2;")
BLOCKS = ("constexpr int kMmaBlocks = 2;", "constexpr int kMmaBlocks = {};")
# the B fragments of a k32 step loaded one n8 tile at a time, each just
# before its mma (as built: all kMmaNt loaded first)
ONE_BY_ONE = ("conv_mma.cuh", """          uint2 b[kMmaNt];
#pragma unroll
          for (int j = 0; j < kMmaNt; ++j)
            if (n0 + j < nt)
              b[j] = __ldg(reinterpret_cast<const uint2*>(consts + mma_off) +
                           wk + (j * ks + c) * 32);
#pragma unroll
          for (int j = 0; j < kMmaNt; ++j)
            if (n0 + j < nt) mma_s8(acc[j], a0, a1, a2, a3, b[j].x, b[j].y);""",
              """#pragma unroll
          for (int j = 0; j < kMmaNt; ++j) {
            if (n0 + j < nt) {
              const uint2 b = __ldg(
                  reinterpret_cast<const uint2*>(consts + mma_off) + wk +
                  (j * ks + c) * 32);
              mma_s8(acc[j], a0, a1, a2, a3, b.x, b.y);
            }
          }""")
# the tensor-core section instantiation: n8 tiles a warp item, the order
# of the B loads, and the blocks an SM its launch bound asks for
MMA_VARIANTS = [
    ("as built (4 n8 tiles, 2 blocks an SM)", "tiled_section.cu",
     "yf_tiled_section", []),
    ("B loads one by one", "tiled_section.cu", "yf_tiled_section",
     [ONE_BY_ONE]),
    ("2 n8 tiles", "tiled_section.cu", "yf_tiled_section", [NT]),
    ("4 blocks an SM", "tiled_section.cu", "yf_tiled_section",
     [(BLOCKS[0], BLOCKS[1].format(4))]),
    ("4 blocks an SM, B loads one by one", "tiled_section.cu",
     "yf_tiled_section", [(BLOCKS[0], BLOCKS[1].format(4)), ONE_BY_ONE]),
]


def _spills(log: str, mma: bool = True) -> str:
    """The compiler's report on an instantiation of the section kernel."""
    lines = log.splitlines()
    tag = f"tiled_section_kernelILb{int(mma)}E"
    for k, line in enumerate(lines):
        if "Compiling entry" in line and tag in line:
            got = [s.split(":")[-1].strip() for s in lines[k + 1:k + 5]
                   if "Used" in s or "spill" in s]
            return "; ".join(got)
    return "?"


def sweep_mma_body(dev) -> None:
    """Each ``MMA_VARIANTS`` section kernel on yolov3-tiny 416 at batch
    256 and the 448 net at 1024 in ``tiled2``, every section launched
    through the variant, held against the library's kernel bit for bit."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_torch_port_golden as tool
    from yoloface_tpu_torch.kernels import arena
    gen = torch.Generator(device=dev).manual_seed(0)
    nets = {"yolov3-tiny 416": (tool.yolov3_tiny_graph(), 256, 416),
            "448 net": (retarget_spatial(load_tflite(CORPUS), 8), 1024,
                        448)}
    plans = {}
    for name, (g, batch, size) in nets.items():
        eng = Int8Engine(g, "tiled2", device=dev)
        x = torch.randint(-128, 128, (batch, size, size, 3), generator=gen,
                          device=dev, dtype=torch.int8)
        plans[name] = (eng, x, eng.arena.run_stages(x))
    for k, (label, *spec) in enumerate(MMA_VARIANTS):
        lib, entry, log = variant_library(100 + k, *spec)
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES["yf_tiled_section"]
        fn.restype = ctypes.c_int
        line = []
        for name, (eng, x, env) in plans.items():
            p = eng.arena
            n = x.shape[0]

            def run(check=False):
                for j, st in enumerate(p.stages):
                    ins = [env[i] for i in st.inputs]
                    outs = [torch.empty_like(env[o]) for o in st.outputs]
                    ptrs = (ctypes.c_uint64 * arena.MAX_GLOBALS)(
                        *[t.data_ptr() for t in ins + outs])
                    _build.check(fn(
                        getattr(p, f"descs{j}").data_ptr(), st.descs.shape[0],
                        getattr(p, f"consts{j}").data_ptr(), ptrs,
                        len(st.globals_), n, st.strips, st.arena_bytes,
                        arena.THREADS, int(st.mma_convs > 0), _stream(dev)),
                        label)
                    if check:
                        for o, t in zip(st.outputs, outs):
                            same(t, env[o], f"{label} {name} section {j}")
            run(check=True)
            line.append(f"{name} {time_ms(run, dev, 5):.3f} ms")
        print(f"[sweep] section kernel, {label}: {'; '.join(line)} "
              f"(ptxas, tensor-core instantiation: {_spills(log)}; the "
              f"other: {_spills(log, False)})", flush=True)


def sweep_mma(dev) -> None:
    """``tiled2`` at each ``MMA_MIN_K``: yolov3-tiny 416 at 256 and the
    448 net at 1024."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_torch_port_golden as tool
    gen = torch.Generator(device=dev).manual_seed(0)
    nets = {"yolov3-tiny 416": (tool.yolov3_tiny_graph(), 256, 416),
            "448 net": (retarget_spatial(load_tflite(CORPUS), 8), 1024,
                        448)}
    default = tiled.MMA_MIN_K
    for name, (g, batch, size) in nets.items():
        x = torch.randint(-128, 128, (batch, size, size, 3), generator=gen,
                          device=dev, dtype=torch.int8)
        want = None
        for k in MMA_THRESHOLDS:
            tiled.MMA_MIN_K = 1 << 30 if k is None else k
            eng = Int8Engine(g, "tiled2", device=dev)
            tiled.MMA_MIN_K = default
            marked = sum(s.mma_convs for s in eng.arena.stages)
            got = eng(x[:2])
            got = got if isinstance(got, tuple) else (got,)
            if want is None:
                want = got
            for u, v in zip(got, want):
                same(u, v, f"{name} MMA_MIN_K {k}")
            ms = time_ms(lambda: eng(x), dev, 5)
            print(f"[sweep] {name} tiled2 N={batch}, MMA_MIN_K {k} "
                  f"({marked} convs marked): {ms:.3f} ms, bit-exact vs no "
                  "mark", flush=True)
        del x


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
    sweeps = {"copy": sweep_copy, "pad": sweep_pad, "mma": sweep_mma,
              "mma_body": sweep_mma_body}
    for name in argv or list(sweeps):
        sweeps[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
