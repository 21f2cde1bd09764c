#!/usr/bin/env python3
"""Time variants of kernels on a CUDA card: the choices ``PERF.md`` §6
records for ``csrc/probe_copy.cu`` (threads a block x 16-byte loads a
thread has in flight), ``csrc/pad_int8.cu`` (a border chunk merged from
two shared-memory windows or gathered element by element; a launch bound
of six blocks an SM), the tiled section kernel (``csrc/tiled_section.cu``
on ``csrc/stage_ops.cuh``'s bodies: ``mma``, which big-K convs also run on
the k32 body of ``csrc/conv_mma.cuh``, the planner's ``MMA_MIN_K``;
``mma_body``, the blocks an SM each instantiation's launch bound asks
for), ``add`` and ``quantize``, the
per-op ADD kernel (``csrc/add_int8.cu``) and the QUANTIZE tables of
``csrc/eltwise_lut.cu``: tables against the arithmetic in registers, 2, 4
or 8 16-byte loads a thread in flight, 256 or 512 threads a block;
``head``, the head kernels' rank table and one ``redux.sync`` a round
against float keys and shuffle rounds, 4, 8 or 16 frames a block, a
key's anchor by a multiply or a division, the NMS's ballots apart from
its keep chain.  The whole-frame kernels' earlier body sweeps
(``arena_mma``, ``dw4``, ``fused_mma``, ``stem_mma``, ``pool``,
``bodies``, ``exact_epi``), the sections' max-pool scratch rule
(``pool_rule``) and their epilogue sets (``tiled_epi``) are gone with
the options they rejected; their verdicts stand in ``PERF.md`` §6.

Usage (on the card, from the repository root)::

    python3 tools/torch_variant_sweep.py [copy] [pad] [mma] [mma_body]
        [add] [quantize] [head]

Each variant is a copy of the kernel's source with one constant or
condition rewritten, built with the library's ``nvcc`` flags into
``build/yoloface_tpu_torch/sweep/`` and loaded beside the library (or, for
``mma``, the library with a planner constant set).
Every variant is held bit for bit against the plain version, or the
library's kernel, on the input it is timed on (a mismatch raises), then
timed as the repository times the kernel: the per-frame copy as a call in
a chain of 20 (B9.10's method, beside ``Tensor.clone``), each corpus PAD
at batch 16384 in device time behind a spin (beside ``F.pad``).  The
section sweeps run the 448 net at batch 1024 and yolov3-tiny at 416 at
256 through ``Int8Engine`` (each held against the first variant, or the
library's kernel, on 2 frames) and time the batch in device time; the
kernel variants also print each instantiation's registers and spills
(``nvcc -Xptxas -v``).  The ``add`` and ``quantize`` variants hold each
corpus ADD (QUANTIZE) program against its plain version on the inputs it
is timed on, then time it at 16384 in device time behind a spin, in fast
and exact bits, summed over the three ops.  The ``head`` variants hold
each head kernel against its plain version on the corpus net's output and
on a tie-heavy set (``tools/make_torch_port_golden.tie_heavy_heads``) at
16384 and time it there in device time behind a spin.  Imports no jax.
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
from yoloface_tpu_torch.kernels import (  # noqa: E402
    _build, move, perop, tiled)
from yoloface_tpu_torch.probes import (  # noqa: E402
    same, time_chain, time_ms)
from yoloface_tpu_torch.runtime.engine import Int8Engine  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tools"))

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
    to ``source``, ``(header, old, new)`` to a header it includes.  Every
    header is copied beside the variant's source, so a header that
    includes another finds the variant's copy.  -> (the library, the
    entry's name in it, the compiler's register and spill report)."""
    out = _build.BUILD_DIR / "sweep" / f"{entry}_v{k}"
    out.mkdir(parents=True, exist_ok=True)
    texts = {h.name: h.read_text() for h in _build.CSRC.glob("*.cuh")}
    texts[source] = (_build.CSRC / source).read_text()
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
                          "-v", "-I", str(out), "-shared", "-o", str(so),
                          str(out / source)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-4000:]}")
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


# MMA_MIN_K candidates; None marks no conv for the k32 body (every conv on
# stage_ops.cuh's m16n8k16 bodies).  16 marks every conv of ci >= 16 (the
# 448 net's two 1x1s of ci 32 and 48); 288 and 576 leave yolov3-tiny's
# layers 2 (K 144) and 4 (K 288) to the m16n8k16 bodies
MMA_THRESHOLDS = (None, 16, 64, 288, 576)


def _tiled_nets(dev, which=("yolov3-tiny 416", "448 net")):
    """{name: (graph, timed input)}: yolov3-tiny at 416 at batch 256 and
    the 448 net at 1024, seeded int8 frames on the card."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_torch_port_golden as tool
    gen = torch.Generator(device=dev).manual_seed(0)
    nets = {"yolov3-tiny 416": (tool.yolov3_tiny_graph, 256, 416),
            "448 net": (lambda: retarget_spatial(load_tflite(CORPUS), 8),
                        1024, 448)}
    return {name: (graph(), torch.randint(
        -128, 128, (batch, size, size, 3), generator=gen, device=dev,
        dtype=torch.int8)) for name, (graph, batch, size) in nets.items()
        if name in which}


def sweep_mma(dev) -> None:
    """``tiled2`` and ``tiled_exact`` at each ``MMA_MIN_K``: yolov3-tiny at
    416 (batch 256) and the 448 net (1024), each held against the plan
    with no conv on the k32 body bit for bit on 2 frames; the big-K convs
    on the k32 body (``csrc/conv_mma.cuh``) against the m16n8k16 bodies
    (``csrc/stage_ops.cuh``) on the same convs."""
    default = tiled.MMA_MIN_K
    for name, (g, x) in _tiled_nets(dev).items():
        for mode in ("tiled2", "tiled_exact"):
            want = None
            for k in MMA_THRESHOLDS:
                tiled.MMA_MIN_K = 1 << 30 if k is None else k
                try:
                    eng = Int8Engine(g, mode, device=dev)
                finally:
                    tiled.MMA_MIN_K = default
                marked = sum(s.k32_convs for s in eng.arena.stages)
                got = eng(x[:2])
                got = got if isinstance(got, tuple) else (got,)
                if want is None:
                    want = got
                for u, v in zip(got, want):
                    same(u, v, f"{name} {mode} MMA_MIN_K {k}")
                ms = time_ms(lambda: eng(x), dev, 5)
                print(f"[sweep] {name} {mode} N={x.shape[0]}, MMA_MIN_K {k} "
                      f"({marked} convs on the k32 body): {ms:.3f} ms, "
                      "bit-exact vs none", flush=True)
        del x


def _blocks(name: str, n: int):
    """The substitution of tiled_section.cu's blocks an SM ``name``."""
    built = {"kSectionBlocks": 3, "kK32Blocks": 2}[name]
    return ("tiled_section.cu", f"constexpr int {name} = {built};",
            f"constexpr int {name} = {n};")


# the blocks an SM each instantiation's launch bound asks for
BLOCKS_VARIANTS = [
    ("as built (fast and exact 3 blocks an SM, k32 2)", []),
    ("fast and exact 4 blocks an SM", [_blocks("kSectionBlocks", 4)]),
    ("fast and exact 2 blocks an SM", [_blocks("kSectionBlocks", 2)]),
    ("k32 3 blocks an SM", [_blocks("kK32Blocks", 3)]),
    ("as built, again", []),
]


_VARIANTS = iter(range(200, 10 ** 6))      # a build directory each


def _build_all(variants, source: str, entry: str):
    """``variant_library`` of each variant (its substitutions), the builds
    run at once; -> [(library, entry, report)] in order."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = [(next(_VARIANTS), source, entry, subs) for _, subs in variants]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(lambda job: variant_library(*job), jobs))


def _section_report(log: str) -> str:
    """The compiler's registers and spills of each instantiation of the
    section kernel, traced twins included."""
    import re
    lines = log.splitlines()
    found = []
    for k, line in enumerate(lines):
        m = re.search(r"tiled_section_kernelILb(\d)ELb(\d)ELb(\d)E", line)
        if "Compiling entry" in line and m:
            got = [s.split(":")[-1].strip() for s in lines[k + 1:k + 5]
                   if "Used" in s or "spill" in s]
            tag = ("exact" if m[1] == "1" else "fast") + (
                ",k32" if m[2] == "1" else "") + (
                ",traced" if m[3] == "1" else "")
            found.append(f"{tag}: " + "; ".join(got))
    return " | ".join(found) or "?"


def _sweep_tiled(dev, variants, tag: str,
                 modes=("tiled2", "tiled", "tiled_exact")) -> None:
    """Each variant of the section kernel (``csrc/tiled_section.cu``): its
    registers and spills, then the 448 net at 1024 and yolov3-tiny at 416
    at 256 in each mode with every launch through the variant, each held
    against the library's kernel bit for bit on 2 frames first."""
    nets = _tiled_nets(dev)
    engines = {(name, mode): Int8Engine(g, mode, device=dev)
               for name, (g, _) in nets.items() for mode in modes}
    want = {key: eng(nets[key[0]][1][:2]) for key, eng in engines.items()}
    lib = _build.library()
    built = lib.yf_tiled_section
    libs = _build_all(variants, "tiled_section.cu", "yf_tiled_section")
    for (label, *_), (vlib, entry, log) in zip(variants, libs):
        fn = getattr(vlib, entry)
        fn.argtypes = _build.SIGNATURES["yf_tiled_section"]
        fn.restype = ctypes.c_int
        lib.yf_tiled_section = fn       # every launch through it
        try:
            line = []
            for (name, mode), eng in engines.items():
                x = nets[name][1]
                got = eng(x[:2])
                for u, v in zip(got if isinstance(got, tuple) else (got,),
                                want[(name, mode)] if isinstance(
                                    got, tuple) else (want[(name, mode)],)):
                    same(u, v, f"{tag} {label} {name} {mode}")
                line.append(f"{name} {mode} "
                            f"{time_ms(lambda: eng(x), dev, 5):.3f}")
        finally:
            lib.yf_tiled_section = built
        print(f"[sweep] {tag} {label}: ms {'; '.join(line)} (ptxas: "
              f"{_section_report(log)})", flush=True)


def sweep_mma_body(dev) -> None:
    _sweep_tiled(dev, BLOCKS_VARIANTS, "mma_body")


def _flat_report(log: str, kernel: str) -> str:
    """The compiler's registers and spills of a kernel, each
    instantiation's (exact: ``ILb1E``, fast: ``ILb0E``)."""
    lines = log.splitlines()
    found = []
    for k, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            got = [s.split(":")[-1].strip() for s in lines[k + 1:k + 5]
                   if "Used" in s or "spill" in s]
            tag = ("exact: " if "ILb1E" in line else
                   "fast: " if "ILb0E" in line else "")
            found.append(tag + "; ".join(got))
    return " | ".join(found) or "?"


# The per-op ADD (B8.6, add_int8.cu) and QUANTIZE (B8.7, the QUANTIZE tables
# of eltwise_lut.cu): each input's terms (or the op's byte table) in
# shared memory against the arithmetic in registers, a byte (pair) at a
# time; the 16-byte loads a thread has in flight; the threads a block
THREADS_256 = "constexpr int kThreads = 256;"
ADD_IN_FLIGHT = "constexpr int kAddInFlight = 2;"
ADD_TABLES = """    const uint32_t sa = ta[ua], sb = ta[yf::kTableBytes + ub];
    if (kExact)
      return yf::requant_exact(static_cast<int>(sa) + static_cast<int>(sb),
                               m2, e2, zp_out);
    return yf::round_zp_clip(__fadd_rn(__uint_as_float(sa),
                                       __uint_as_float(sb)), zp_out);"""
ADD_REGISTERS = """    const int va = static_cast<int8_t>(ua) - zp_a;
    const int vb = static_cast<int8_t>(ub) - zp_b;
    if (kExact)
      return yf::add_exact(va, vb, lsh, m0, e0, m1, e1, m2, e2, zp_out);
    return yf::add_fast(va, vb, f0, f1, zp_out);"""
# the op's fields the arithmetic reads, copied into the functor
ADD_FIELDS = [
    ("  int m2, e2, zp_out;\n", "  int m2, e2, zp_out;\n"
     "  int zp_a, zp_b, lsh, m0, e0, m1, e1;\n  float f0, f1;\n"),
    *((f"AddFn<{x}>{{terms, {m}, op.zp_out}}",
       f"AddFn<{x}>{{terms, {m}, op.zp_out, op.zp_a, op.zp_b, op.lsh, "
       "op.m0, op.e0, op.m1, op.e1, op.f0, op.f1}")
      for x, m in (("true", "op.m2, op.e2"), ("false", "0, 0")))]
ADD_VARIANTS = [
    ("as built (tables, 2 in flight, 256 threads)", []),
    ("arithmetic in registers", [(ADD_TABLES, ADD_REGISTERS),
                                 *ADD_FIELDS]),
    *((f"{k} in flight", [(ADD_IN_FLIGHT, f"constexpr int kAddInFlight = "
                                          f"{k};")]) for k in (1, 4, 8)),
    ("512 threads", [(THREADS_256, "constexpr int kThreads = 512;")]),
    ("as built, again", []),
]
KERNEL_LINE = """__global__ void __launch_bounds__(kThreads)
    eltwise_lut_kernel("""
# QUANTIZE by the epilogue functions a byte at a time (the timed programs
# are all QUANTIZEs)
QUANT_FN = """struct QuantFn {
  int zp_a, m0, e0, zp_out;
  float f0;
  bool exact;
  __device__ int8_t operator()(int8_t x) const {
    return exact ? yf::requant_exact(x - zp_a, m0, e0, zp_out)
                 : yf::quantize_fast(x - zp_a, f0, zp_out);
  }
  __device__ unsigned operator()(unsigned w) const {
    unsigned r = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r |= static_cast<unsigned>(static_cast<uint8_t>((*this)(
               static_cast<int8_t>((w >> (8 * k)) & 255)))) << (8 * k);
    return r;
  }
  __device__ uint4 operator()(uint4 v) const {
    return make_uint4((*this)(v.x), (*this)(v.y), (*this)(v.z), (*this)(v.w));
  }
};

"""
QUANT_VARIANTS = [
    ("as built (table, 4 in flight, 256 threads)", []),
    ("arithmetic in registers",
     [(KERNEL_LINE, QUANT_FN + KERNEL_LINE),
      ("yf::TableFn{lut}", "QuantFn{desc->zp_a, desc->m0, desc->e0, "
       "desc->zp_out, desc->f0, desc->epi == yf::EPI_REQUANT_EXACT}")]),
    *((f"{k} in flight", [("arena_ops.cuh", "constexpr int kInFlight = 4;",
                           f"constexpr int kInFlight = {k};")])
      for k in (2, 8)),
    ("512 threads", [(THREADS_256, "constexpr int kThreads = 512;")]),
    ("as built, again", []),
]


def _sweep_flat(dev, variants, source: str, entry: str, kernel: str,
                tag: str) -> None:
    """Each variant of a flat per-op kernel on the corpus net's programs
    of ``kernel`` (``add_int8``, ``requantize_int8``) at 16384, in fast and
    exact bits: each op held against its plain version on its timed
    inputs, then timed in device time behind a spin; ms summed over the
    ops, each op's beside."""
    from yoloface_tpu_torch.kernels import eltwise
    g = load_tflite(CORPUS)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-128, 128, (16384, 56, 56, 3), generator=gen,
                      device=dev, dtype=torch.int8)
    progs = {}
    for bits in perop.BITS:
        p = perop.PerOpPlan(g, bits).to(dev)
        env = p.run_stages(x)
        progs[bits] = []
        for k, st in enumerate(p.stages):
            if st.kernel != kernel:
                continue
            d = getattr(p, f"descs{k}")
            ins = ([env[st.inputs[0]]] if kernel != "add_int8" else
                   list(perop.add_inputs(st, [env[i] for i in st.inputs])))
            want = (eltwise.add_flat_plain(d, *ins) if kernel == "add_int8"
                    else eltwise.eltwise_lut_plain(d, ins[0]))
            progs[bits].append((d, ins, want))
        del env
    libs = _build_all(variants, source, entry)
    for (label, *_), (vlib, name, log) in zip(variants, libs):
        fn = getattr(vlib, name)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        line = []
        for bits, ops in progs.items():
            times = []
            for j, (d, ins, want) in enumerate(ops):
                out = torch.empty_like(want)

                def call(d=d, ins=ins, out=out):
                    _build.check(fn(d.data_ptr(),
                                    *[t.data_ptr() for t in ins],
                                    out.data_ptr(), out.numel(),
                                    _stream(dev)), f"{tag} {label}")
                call()
                same(out, want, f"{tag} {label} {bits} op {j}")
                times.append(time_ms(call, dev, 10))
            line.append(f"{bits} {sum(times):.4f} ("
                        + ", ".join(f"{t:.4f}" for t in times) + ")")
        print(f"[sweep] {tag} {label}: ms at 16384 over the corpus's "
              f"{len(ops)} ops: {'; '.join(line)} (ptxas: "
              f"{_flat_report(log, kernel_name(entry))})", flush=True)


def kernel_name(entry: str) -> str:
    """The kernel a flat entry launches, as ptxas names it."""
    return {"yf_add_int8": "add_int8_kernel",
            "yf_eltwise_lut": "eltwise_lut_kernel"}[entry]


def sweep_add(dev) -> None:
    _sweep_flat(dev, ADD_VARIANTS, "add_int8.cu", "yf_add_int8", "add_int8",
                "add")


def sweep_quantize(dev) -> None:
    _sweep_flat(dev, QUANT_VARIANTS, "eltwise_lut.cu", "yf_eltwise_lut",
                "requantize_int8", "quantize")


# The head (B4 detect_head.cu, B5 topk_conf.cu, on topk.cuh): the rank
# table and one redux.sync a round as built (16 frames a block, a key's
# anchor by a multiply), at 4 and 8 frames a block, the anchor by a
# division, against the float keys from the table with PR 14's shuffle
# rounds, PR 14's form (each lane's keys by sigm, the shuffle rounds),
# and, for the fused head, the NMS's overlap ballots taken apart from its
# keep chain (each round's ballot independent of the kept boxes, then the
# greedy chain on bit masks through shared memory).
FLOAT_TOPK = r"""// Lane `lane`'s float keys from the block's table: key[j] is flat cell
// lane + 32*j; padding slots sit below every real key.
__device__ __forceinline__ void load_keys(const int8_t* y, int lane,
                                          int cells, int c6, int n_keys,
                                          const float* tkey,
                                          float (&key)[kKeysPerLane]) {
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int f = lane + 32 * j;
    key[j] = -2.0f;
    if (f < n_keys) {
      const int an = f / cells, rc = f % cells;
      key[j] = tkey[y[rc * c6 + an * 6 + 4] + 128];
    }
  }
}
"""
SIGM_KEYS = r"""// Lane `lane`'s keys of frame `y`, each by sigm (PR 14's form).
__device__ __forceinline__ void load_keys(const int8_t* y, int lane,
                                          int cells, int c6, int n_keys,
                                          float zp, float scale, float thr,
                                          float (&key)[kKeysPerLane]) {
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int f = lane + 32 * j;
    key[j] = -2.0f;
    if (f < n_keys) {
      const int an = f / cells, rc = f % cells;
      const float q = static_cast<float>(y[rc * c6 + an * 6 + 4]);
      const float cf = sigm(__fmul_rn(__fsub_rn(q, zp), scale));
      key[j] = cf >= thr ? cf : 0.0f;
    }
  }
}
"""
FLOAT_ROUNDS = r"""// K masked-argmax rounds over the warp's float keys, 5 shuffle pairs a
// round (the float form; the integer rounds stay for the block path).
template <int kN, unsigned kIdx>
__device__ __forceinline__ int warp_topk(float (&key)[kN], int lane, int k) {
  int mine = 0;
  for (int kk = 0; kk < k; ++kk) {
    float best = -3.0f;
    int bi = 1 << 30;
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      if (key[j] > best) {
        best = key[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j)
      if (lane + 32 * j == bi) key[j] = -1.0f;
    if (lane == kk) mine = bi;
  }
  return mine;
}

"""
TOPK_TAIL = "// Lane `lane`'s candidates of frame `y`"
TOPK_ROUNDS = "// K masked-argmax rounds over the warp's candidates"


def _topk_tail(text: str):
    """The substitution of topk.cuh's load_keys by ``text``, in front of
    its integer rounds."""
    src = (_build.CSRC / "topk.cuh").read_text()
    return ("topk.cuh", src[src.index(TOPK_TAIL):src.index(TOPK_ROUNDS)],
            text)


def _float_keys(source: str, sigm: bool):
    subs = [_topk_tail((SIGM_KEYS if sigm else FLOAT_TOPK) + "\n"
                       + FLOAT_ROUNDS),
            (source, "  unsigned key[yf::kKeysPerLane];",
             "  float key[yf::kKeysPerLane];")]
    call = ("(yq, lane, cells, c6, n_keys, table.hi, key)"
            if source == "detect_head.cu" else
            "(y + frame * cells * c6, lane, cells, c6, cells * a, table.hi,\n"
            "                key)")
    args = ("h.zp, h.scale, h.thr" if source == "detect_head.cu" else
            "zp, scale, thr")
    new = call.replace("table.hi", args if sigm else "table.key")
    subs.append((source, f"yf::load_keys{call}", f"yf::load_keys{new}"))
    if sigm:     # the warp path's table (the block path keeps its own)
        subs.append((source, "  __shared__ yf::RankTable table;\n"
                     f"  yf::build_rank_table(table, {args});\n", ""))
    return subs


NMS_BUILT = """      const unsigned any = __ballot_sync(kFull, over);
      if (lane == i) keep = keep && any == 0u;
    }
  }"""
NMS_APART = """      const unsigned any = __ballot_sync(kFull, over);
      if (lane == 0) over_of[threadIdx.x >> 5][i] = any;
    }
    __syncwarp();
    const unsigned valid = __ballot_sync(kFull, keep);
    unsigned kept = valid & 1u;
    for (int i = 1; i < k; ++i)
      if (((valid >> i) & 1u) && (over_of[threadIdx.x >> 5][i] & kept) == 0u)
        kept |= 1u << i;
    keep = ((kept >> lane) & 1u) != 0u;
  }"""
NMS_SUBS = [("detect_head.cu", NMS_BUILT, NMS_APART),
            ("detect_head.cu", "        over = iou > h.iou_thr && keep;",
             "        over = iou > h.iou_thr;"),
            ("detect_head.cu", """  if (h.apply_nms) {
    const float area""", """  __shared__ unsigned over_of[kWarpsPerBlock][32];
  if (h.apply_nms) {
    const float area""")]


def _warps(source: str, w: int):
    return [(source, "constexpr int kWarpsPerBlock = 16;",
             f"constexpr int kWarpsPerBlock = {w};")]


DIVIDE = [("topk.cuh", """      const int an = cells > 1 ? static_cast<int>(__umulhi(
                                     static_cast<unsigned>(f), magic))
                               : f;
      const int rc = f - an * cells;""", """      const int an = f / cells, rc = f % cells;""")]


def _head_variants(source: str):
    v = [("as built (the rank table, one redux.sync a round, 16 frames a "
          "block, the anchor by a multiply)", []),
         ("4 frames a block", _warps(source, 4)),
         ("8 frames a block", _warps(source, 8)),
         ("the anchor by a division", DIVIDE),
         ("the float keys from the table, shuffle rounds",
          _float_keys(source, False)),
         ("PR 14's form (each lane's keys by sigm, shuffle rounds)",
          _float_keys(source, True))]
    if source == "detect_head.cu":
        v += [("the NMS ballots apart from its keep chain", NMS_SUBS)]
    return v + [("as built, again", [])]


def sweep_head(dev) -> None:
    from yoloface_tpu_torch.kernels import head as khead
    from yoloface_tpu_torch.kernels.preprocess import preprocess_rgb565
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    n = 16384
    pipe = load_pipeline(CORPUS, mode="arena2", device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(-1 << 15, 1 << 15, (n, 112, 112), generator=gen,
                           device=dev, dtype=torch.int16).view(torch.uint16)
    kw = dict(scale=pipe._out_scale, zero_point=pipe._out_zp)
    import make_torch_port_golden as golden
    heads = {"net": pipe.engine(preprocess_rgb565(frames)),
             "tie-heavy": torch.from_numpy(golden.tie_heavy_heads(n)).to(dev)}
    lib = _build.library()
    for source, entry, call, plain in (
            ("detect_head.cu", "yf_detect_head",
             lambda y: khead.detect_head(y, **kw),
             lambda y: khead.detect_head_plain(y, **kw)),
            ("topk_conf.cu", "yf_topk_conf",
             lambda y: (khead.topk_conf(y, 16, **kw),),
             lambda y: (khead.topk_conf_plain(y, 16, **kw),))):
        variants = _head_variants(source)
        built = getattr(lib, entry)
        libs = _build_all(variants, source, entry)
        kernel = entry[3:] + "_kernel"
        for (label, *_), (vlib, name, log) in zip(variants, libs):
            fn = getattr(vlib, name)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            setattr(lib, entry, fn)
            try:
                line = []
                for what, y in heads.items():
                    for u, v in zip(call(y), plain(y)):
                        same(u, v, f"head {label} {entry} {what}")
                    ms = time_ms(lambda y=y: call(y), dev, 10)
                    line.append(f"{what} {ms:.4f}")
            finally:
                setattr(lib, entry, built)
            print(f"[sweep] head {entry[3:]} {label}: ms at {n}: "
                  f"{', '.join(line)} (ptxas: {_flat_report(log, kernel)})",
                  flush=True)


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
              "mma_body": sweep_mma_body, "add": sweep_add,
              "quantize": sweep_quantize, "head": sweep_head}
    for name in argv or list(sweeps):
        sweeps[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
