#!/usr/bin/env python3
"""Time variants of kernels on a CUDA card: the choices ``PERF.md`` §6
records for ``csrc/probe_copy.cu`` (threads a block x 16-byte loads a
thread has in flight), ``csrc/pad_int8.cu`` (a border chunk merged from
two shared-memory windows or gathered element by element; a launch bound
of six blocks an SM), the tiled planner's ``MMA_MIN_K`` (which convs run
on the tensor cores, ``csrc/conv_mma.cuh``), the tensor-core section
instantiation (n8 tiles a warp item, the order of its B loads, the blocks
an SM its launch bound asks for) and the whole-frame kernels' conv bodies
(``csrc/stage_ops.cuh``: ``arena_mma``, the 1x1 tensor-core body's k
depth and tiles a warp item, the kernels' launch bound and the epilogues
compiled into the arena kernel's bodies; ``dw4``, the channels a thread
of the depthwise body owns; ``fused_mma``, the epilogues compiled into
the fused kernel's bodies; ``stem_mma``, the full-window conv body's K
padding (27 -> 32 against 16 a window row), its byte or funnel-shifted A
gathers, the epilogues compiled into it in both kernels, and the per-op
stem reading device memory directly or staged in shared memory;
``pool``, the max-pool's register walk against a separable word pass
through a scratch, and the per-op pools direct or staged; ``bodies``, the
full-window conv body on every marked conv against the 1x1 body beside
it, and the kernels with the full-window body and the word passes
compiled out, each with its stage time by op kind; ``add`` and
``quantize``, the per-op ADD kernel (``csrc/add_int8.cu``) and the
QUANTIZE tables of ``csrc/eltwise_lut.cu``: tables against the
arithmetic in registers, 2, 4 or 8 16-byte loads a thread in flight, 256
or 512 threads a block; ``exact_epi``, the whole-frame kernels' exact
epilogues: the fused leaky from the op's table against a second MBQM,
``mbqm32`` against the 64-bit MBQM, a second instantiation against one
kernel, the fast v1 leaky's table against its second rounding in floats;
``head``, the head kernels' rank table and one ``redux.sync`` a round
against float keys and shuffle rounds, 4, 8 or 16 frames a block, a
key's anchor by a multiply or a division, the NMS's ballots apart from
its keep chain).  The header
holds only the shapes chosen (m16n8k16, one m16 by one n8 tile a warp
item, 4 channels a depthwise thread, K padded as a whole, byte gathers,
the register walk, direct reads); the others are built from the general
bodies kept here (``WIDE_MMA_BODY``, ``WIDE_DW_BODY``, ``FUNNEL``,
``ROW_K``, ``SEP_WORDS_BODY``, ``STAGE_FRAME``), put in place of the
header's.

Usage (on the card, from the repository root)::

    python3 tools/torch_variant_sweep.py [copy] [pad] [mma] [mma_body]
        [arena_mma] [dw4] [fused_mma] [stem_mma] [pool] [bodies]
        [add] [quantize] [exact_epi] [head]

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
bit for bit on 2 frames, and times the batch in device time.  The
``arena_mma`` and ``dw4`` (``fused_mma``) sweeps print each arena (fused)
kernel variant's registers and spills, hold it against the plain version
on 37 frames in each bit semantics, and time the corpus net's stages at
16384 in each and the ``arena2`` (``fused``) pipeline at 65536 with every
launch of the kernel through the variant; the per-op variants hold each
B8.3 (B8.5) program against its plain version on its timed inputs and
time it at 16384 in fast and exact bits.  The ``add`` and ``quantize``
variants hold each corpus ADD (QUANTIZE) program against its plain
version on the inputs it is timed on, then time it at 16384 in device
time behind a spin, in fast and exact bits, summed over the three ops.
The ``exact_epi`` variants run as ``arena_mma`` and ``fused_mma`` do, with
the ``arena_exact`` and ``fused_exact`` pipelines, and on the per-op conv
programs; the ``head`` variants hold each head kernel against its plain
version on the corpus net's output and on a tie-heavy set
(``tools/make_torch_port_golden.tie_heavy_heads``) at 16384 and time it
there in device time behind a spin.  Imports no jax.
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
    _build, arena, move, perop, tiled)
from yoloface_tpu_torch.probes import (  # noqa: E402
    same, time_chain, time_ms)
from yoloface_tpu_torch.runtime.engine import Int8Engine  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_profile_pipeline as prof  # noqa: E402

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


# the whole-frame stage kernels' conv bodies (csrc/stage_ops.cuh), swept
# on the arena kernel: the k depth of an mma step, n8 and m16 tiles a warp
# item, the blocks an SM the launch bound asks for; then the channel words
# a thread of the depthwise body owns.  (B fragments staged in shared
# memory beyond the arena were not tried: they come through the read-only
# cache.)
STAGE = "stage_ops.cuh"


# stage_ops.cuh's constants as built: (type, value)
STAGE_BUILT = {"kStageBlocks": ("int", "4"),
               "kArenaMmaEpis": ("unsigned", "kFastEpis"),
               "kArenaConvEpis": ("unsigned", "1u << EPI_LEAKY_V2"),
               "kFusedConvEpis": ("unsigned", "1u << EPI_LEAKY_V1"),
               "kArenaDwEpis": ("unsigned", "1u << EPI_LEAKY_V2"),
               "kFusedMmaEpis": ("unsigned", "kV1Epis"),
               "kFusedDwEpis": ("unsigned", "kV1Epis"),
               "kTableEpis": ("unsigned", "(1u << EPI_LEAKY_EXACT) | "
                                          "(1u << EPI_LEAKY_V1)"),
               "kMbqm32": ("bool", "true")}
EXACT_EPIS = "(1u << EPI_REQUANT_EXACT) | (1u << EPI_LEAKY_EXACT)"


def _stage(**knobs):
    """Substitutions of stage_ops.cuh's constants (``kStageBlocks=5``,
    ``kArenaDwEpis="0"`` ...), each from its value as built."""
    subs = []
    for name, v in knobs.items():
        kind, built = STAGE_BUILT[name]
        subs.append((STAGE, f"constexpr {kind} {name} = {built};",
                     f"constexpr {kind} {name} = {v};"))
    return subs


# The 1x1 tensor-core body for any k depth of an mma step (16: m16n8k16,
# one packed fragment; 32: m16n8k32, two, the second 0 past the packed
# ones) and kStageNt n8 by kStageMt m16 tiles a warp item; @K@, @NT@ and
# @MT@ name them.  At 16, 1 and 1 it computes what stage_ops.cuh's
# conv1x1_mma_body does.
WIDE_MMA_BODY = r"""// A marked 1x1 CONV + epilogue kEpi (the op's) over the whole frame on the
// tensor cores; `in` and `out` point at the views' first bytes.  All
// threads of the block take part: warp w takes the warp items w, w +
// warps, ..., m16 tiles fastest.  A lane stores its two channels of a row
// as one 16-bit word where the output view allows.
template <int kEpi>
static __device__ void conv1x1_mma_body(const Op& op, const int8_t* in,
                                        int8_t* out, const uint8_t* consts) {
  constexpr int kStageK = @K@, kStageNt = @NT@, kStageMt = @MT@;
  constexpr int kSub = kStageK / 16;       // packed k16 fragments a step
  constexpr int kRows = 2 * kStageMt;      // a lane's rows of an item
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ow = op.out.w, co_n = op.out.c, ci = op.in0.c, cs = op.in0.cs;
  const int m_n = op.out.h * ow;                           // output pixels
  const int mt = (m_n + 16 * kStageMt - 1) / (16 * kStageMt);
  const int nt = (co_n + 7) >> 3;                          // n8 tiles
  const int ks = (ci + 15) >> 4;           // packed k16 fragments
  const int kr = (ci + kStageK - 1) / kStageK * kSub;      // steps run
  const bool words = ((addr(in) | static_cast<uintptr_t>(cs)) & 3) == 0;
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  const unsigned* frag =
      reinterpret_cast<const unsigned*>(consts + op.frag_off) + lane;
  // a 1x1 at stride 1 without a pad reads pixel p of the input at p * cs
  const bool direct = op.sh == 1 && op.sw == 1 && op.pt == 0 &&
                      op.pl == 0 && op.in0.w == ow && op.in0.h >= op.out.h;
  const bool pairs =            // channels 2t, 2t + 1 as one 16-bit store
      ((addr(out) | static_cast<uintptr_t>(op.out.cs)) & 1) == 0;
  const int groups = (nt + kStageNt - 1) / kStageNt, warps = blockDim.x >> 5;
  // the warp's item: m16 tile group mi of n8 tile group ng, m fastest
  int mi = threadIdx.x >> 5, ng = 0;
  while (mi >= mt) mi -= mt, ++ng;
  for (; ng < groups; mi += warps) {
    while (mi >= mt) mi -= mt, ++ng;
    if (ng >= groups) break;
    const int m0 = mi * 16 * kStageMt, n0 = ng * kStageNt;
    int acc[kStageMt][kStageNt][4];
#pragma unroll
    for (int j = 0; j < kStageNt; ++j) {
      const int co = (n0 + j) * 8 + 2 * t;
      const int* bias = reinterpret_cast<const int*>(consts + op.b_off);
      const int b0 = co < co_n ? __ldg(bias + co) : 0;
      const int b1 = co + 1 < co_n ? __ldg(bias + co + 1) : 0;
#pragma unroll
      for (int m = 0; m < kStageMt; ++m) {
        acc[m][j][0] = acc[m][j][2] = b0;
        acc[m][j][1] = acc[m][j][3] = b1;
      }
    }
    // the lane's rows r: pixel m0 + 16 (r / 2) + g + 8 (r % 2), read at
    // in + off[r]; -1: outside the image (the fill), -2: past the last
    // pixel (0)
    int off[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = m0 + 16 * (r >> 1) + g + 8 * (r & 1);
      if (p >= m_n) {
        off[r] = -2;
      } else if (direct) {
        off[r] = p * cs;
      } else {
        const int oy = p / ow, ox = p - oy * ow;
        const int iy = oy * op.sh - op.pt, ix = ox * op.sw - op.pl;
        off[r] = (iy < 0 || iy >= op.in0.h || ix < 0 || ix >= op.in0.w)
                     ? -1
                     : (iy * op.in0.w + ix) * cs;
      }
    }
#pragma unroll 1
    for (int s = 0; s < kr; s += kSub) {
      unsigned a[kRows][kSub];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int h = 0; h < kSub; ++h)
          a[r][h] = off[r] >= 0
                        ? a_word4(in + off[r], 16 * (s + h) + 4 * t, ci, words)
                        : off[r] == -1 ? fill : 0u;
      }
#pragma unroll
      for (int j = 0; j < kStageNt; ++j) {
        if (n0 + j < nt) {
          unsigned b[kSub];
#pragma unroll
          for (int h = 0; h < kSub; ++h)
            b[h] = s + h < ks ? __ldg(frag + ((n0 + j) * ks + s + h) * 32)
                              : 0u;
#pragma unroll
          for (int m = 0; m < kStageMt; ++m) {
            if (kSub == 1)
              mma_k16(acc[m][j], a[2 * m][0], a[2 * m + 1][0], b[0]);
            else
              mma_s8(acc[m][j], a[2 * m][0], a[2 * m + 1][0],
                     a[2 * m][kSub - 1], a[2 * m + 1][kSub - 1], b[0],
                     b[kSub - 1]);
          }
        }
      }
    }
    // c0, c1: row g, channels 2t, 2t + 1; c2, c3: row g + 8
    const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
    const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
#pragma unroll
    for (int m = 0; m < kStageMt; ++m) {
#pragma unroll
      for (int j = 0; j < kStageNt; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m0 + 16 * m + g + 8 * h;
          const int co = (n0 + j) * 8 + 2 * t;
          if (p >= m_n || co >= co_n) continue;
          int8_t* o = out + p * op.out.cs + co;
          const int8_t lo =
              epilogue<kEpi>(op, acc[m][j][2 * h], co, scale, qms);
          if (co + 1 < co_n) {
            const int8_t hi = epilogue<kEpi>(
                op, acc[m][j][2 * h + 1], co + 1, scale, qms);
            if (pairs) {
              *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(
                  static_cast<uint8_t>(lo) | (static_cast<uint8_t>(hi) << 8));
            } else {
              o[0] = lo;
              o[1] = hi;
            }
          } else {
            o[0] = lo;
          }
        }
      }
    }
  }
}

"""
# The depthwise word body for kW 4-byte channel words a thread, kDwWords
# (@W@) where the channel count allows, else one; at 1 it is
# stage_ops.cuh's dw3x3_words_op.
WIDE_DW_BODY = r"""// 3x3 depthwise conv + epilogue kEpi (the op's) over the whole frame, a
// thread owning the kW channel words [4 kW q, 4 kW (q + 1)) for every pixel
// it takes.  The caller guarantees that the input view's first byte,
// channel stride and channel count are multiples of 4, that 4 kW divides
// the channel count and that the block has a thread for each group.
constexpr int kDwWords = @W@;
template <int kW, int kEpi>
static __device__ void dw3x3_words_op(const Op& op, const int8_t* in,
                                      int8_t* out, const uint8_t* consts) {
  constexpr int kC = 4 * kW;
  const int c_n = op.out.c, nq = c_n / kC;
  const int lanes = blockDim.x / nq;          // pixels walked at once
  const int q = threadIdx.x % nq, lane = threadIdx.x / nq;
  if (lane >= lanes) return;                  // the block's last threads
  const int c0 = q * kC;
  const unsigned* w = reinterpret_cast<const unsigned*>(
      consts + op.w_off + c0);                // [1,3,3,C]: tap k at k * C
  const int* bias = reinterpret_cast<const int*>(consts + op.b_off) + c0;
  const float* scale = reinterpret_cast<const float*>(consts + op.s_off);
  const int* qms = reinterpret_cast<const int*>(consts + op.q_off);
  unsigned wk[9][kW];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int u = 0; u < kW; ++u) wk[k][u] = __ldg(w + k * (c_n / 4) + u);
  }
  int b[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) b[j] = __ldg(bias + j);
  const int ow = op.out.w, m_n = op.out.h * ow;
  const int in_h = op.in0.h, in_w = op.in0.w, cs = op.in0.cs;
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  const bool out_words =
      ((addr(out) | static_cast<uintptr_t>(op.out.cs)) & 3) == 0;
  // pixel p = oy * ow + ox, stepped by lanes = dy * ow + dx
  const int dy = lanes / ow, dx = lanes - dy * ow;
  int oy = lane / ow, ox = lane - oy * ow;
  for (int p = lane; p < m_n; p += lanes, oy += dy, ox += dx) {
    if (ox >= ow) ox -= ow, ++oy;
    const int y0 = oy * op.sh - op.pt, x0 = ox * op.sw - op.pl;
    int acc[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[j] = b[j];
    const int base = (y0 * in_w + x0) * cs + c0;   // tap (0, 0)'s word
    if (y0 >= 0 && y0 + 3 <= in_h && x0 >= 0 && x0 + 3 <= in_w) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const unsigned* v = reinterpret_cast<const unsigned*>(
            in + base + ((k / 3) * in_w + k % 3) * cs);
#pragma unroll
        for (int u = 0; u < kW; ++u) mac4(acc + 4 * u, v[u], wk[k][u]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int iy = y0 + k / 3, ix = x0 + k % 3;
        const bool inb = iy >= 0 && iy < in_h && ix >= 0 && ix < in_w;
        const unsigned* v = reinterpret_cast<const unsigned*>(
            in + base + ((k / 3) * in_w + k % 3) * cs);
#pragma unroll
        for (int u = 0; u < kW; ++u)
          mac4(acc + 4 * u, inb ? v[u] : fill, wk[k][u]);
      }
    }
    int8_t* o = out + p * op.out.cs + c0;
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      unsigned r = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r |= static_cast<unsigned>(static_cast<uint8_t>(
                 epilogue<kEpi>(op, acc[4 * u + j], c0 + 4 * u + j, scale,
                                qms)))
             << (8 * j);
      if (out_words) {
        reinterpret_cast<unsigned*>(o)[u] = r;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[4 * u + j] = static_cast<int8_t>(r >> (8 * j));
      }
    }
  }
}

// dw3x3_words_op with the op's epilogue, kDwWords words a thread where the
// channel count allows, else one.
struct Dw3x3Words {
  const Op& op;
  const int8_t* in;
  int8_t* out;
  const uint8_t* consts;
  template <int kEpi>
  __device__ void run() const {
    if (kDwWords > 1 && op.out.c % (4 * kDwWords) == 0)
      dw3x3_words_op<kDwWords, kEpi>(op, in, out, consts);
    else
      dw3x3_words_op<1, kEpi>(op, in, out, consts);
  }
};

"""


def _replace_body(first: str, end: str, body: str):
    """The substitution of stage_ops.cuh's text from the line ``first`` up
    to the line ``end`` (not included) by ``body``."""
    text = (_build.CSRC / STAGE).read_text()
    a = text.index(first)
    return (STAGE, text[a:text.index(end, a)], body)


def _wide_mma(k: int = 16, nt: int = 1, mt: int = 1):
    """Substitutions building the 1x1 body at k depth ``k`` with ``nt`` n8
    by ``mt`` m16 tiles a warp item (``mma_s8``, the m16n8k32 step, comes
    from conv_mma.cuh)."""
    body = (WIDE_MMA_BODY.replace("@K@", str(k)).replace("@NT@", str(nt))
            .replace("@MT@", str(mt)))
    return [(STAGE, '#include "arena_ops.cuh"\n',
             '#include "arena_ops.cuh"\n#include "conv_mma.cuh"\n'),
            _replace_body("// A marked 1x1 CONV + epilogue kEpi",
                          "// conv1x1_mma_body with the op's epilogue",
                          body)]


def _wide_dw(words: int):
    """Substitutions building the depthwise body at ``words`` channel
    words a thread where the channel count allows."""
    return [_replace_body("// 3x3 depthwise conv + epilogue kEpi",
                          "// DW + epilogue over the whole frame",
                          WIDE_DW_BODY.replace("@W@", str(words)))]


# the arena kernel's conv bodies on pointers the compiler sees are in
# shared memory (the arena's views: LDS/STS) instead of generic ones
MMA_CALL = "yf::marked_conv_op<kMma, kConv, kExact>"
DW_CALL = "yf::dw_op<kDw, kExact>"
SHARED_VIEWS = [
    (f"""          {MMA_CALL}(op, in0, out, consts);""",
     f"""          if (op.in0.space == 0 && op.out.space == 0)
            {MMA_CALL}(op, arena + op.in0.offset,
                       arena + op.out.offset, consts);
          else
            {MMA_CALL}(op, in0, out, consts);"""),
    (f"""        {DW_CALL}(op, in0, out, consts);""",
     f"""        if (op.in0.space == 0 && op.out.space == 0)
          {DW_CALL}(op, arena + op.in0.offset, arena + op.out.offset,
                    consts);
        else
          {DW_CALL}(op, in0, out, consts);""")]
ARENA_MMA_VARIANTS = [
    ("as built (k16, 1 n8 tile, 1 m16 tile, 4 blocks an SM; the fast "
     "epilogues compiled in the 1x1 body, v2 in the depthwise body)", {}),
    ("every epilogue compiled in both bodies", dict(
        kArenaMmaEpis=f"kFastEpis | {EXACT_EPIS}",
        kArenaDwEpis=f"kFastEpis | {EXACT_EPIS}")),
    ("every epilogue compiled in the 1x1 body",
     dict(kArenaMmaEpis=f"kFastEpis | {EXACT_EPIS}")),
    ("the fast epilogues compiled in both bodies",
     dict(kArenaDwEpis="kFastEpis")),
    ("no epilogue compiled in the depthwise body", dict(kArenaDwEpis="0")),
    ("no epilogue compiled in", dict(kArenaMmaEpis="0", kArenaDwEpis="0")),
    ("shared-memory views", SHARED_VIEWS),
    ("the general 1x1 body at k16, 1 n8 tile, 1 m16 tile", _wide_mma()),
    ("5 n8 tiles, no block bound", dict(kStageBlocks=1), _wide_mma(nt=5)),
    ("5 n8 tiles", _wide_mma(nt=5)),
    ("2 n8 tiles", _wide_mma(nt=2)),
    ("2 m16 tiles", _wide_mma(mt=2)),
    ("k32", _wide_mma(k=32)),
    ("5 blocks an SM", dict(kStageBlocks=5)),
]
DW4_VARIANTS = [
    ("4 channels a thread", {}),
    ("the general depthwise body at 4 channels a thread", _wide_dw(1)),
    ("8 channels a thread (C = 8, 24, 40; 4 for 36)", _wide_dw(2)),
]
# the fused kernel's epilogue sets (its bits are fast, v1, and exact):
# the 1x1 body's set is kFusedMmaEpis, the depthwise body's kFusedDwEpis
V1_EPIS = "kV1Epis"
FUSED_MMA_VARIANTS = [
    ("as built (the fast epilogues compiled in both bodies)", {}),
    ("the fast epilogues compiled in the 1x1 body", dict(kFusedDwEpis="0")),
    ("every epilogue compiled in the 1x1 body",
     dict(kFusedDwEpis="0", kFusedMmaEpis=f"{V1_EPIS} | {EXACT_EPIS}")),
    ("every epilogue in the 1x1 body, the fast ones in the depthwise body",
     dict(kFusedMmaEpis=f"{V1_EPIS} | {EXACT_EPIS}",
          kFusedDwEpis=V1_EPIS)),
    ("every epilogue compiled in both bodies",
     dict(kFusedMmaEpis=f"{V1_EPIS} | {EXACT_EPIS}",
          kFusedDwEpis="kFusedMmaEpis")),
    ("no epilogue compiled in", dict(kFusedMmaEpis="0", kFusedDwEpis="0")),
]


def _stage_report(log: str, kernel: str) -> str:
    """The compiler's registers and spills of a whole-frame kernel, each
    instantiation's (the fast and exact ones of the stage kernels)."""
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


class Marks:
    """A variant's planner: ``mark`` in place of ``arena.mark_mma`` while
    the plans are built."""

    def __init__(self, mark):
        self.mark = mark

    def __enter__(self):
        from yoloface_tpu_torch.kernels import arena
        self.built, arena.mark_mma = arena.mark_mma, self.mark

    def __exit__(self, *exc):
        from yoloface_tpu_torch.kernels import arena
        arena.mark_mma = self.built


class Smem:
    """A variant's launches: every stage of a plan with ``extra`` bytes of
    dynamic shared memory past its own (the arena's ``arena_bytes``, a
    fused or per-op program's scratch), which the variant's bodies take
    from the end."""

    def __init__(self, extra: int):
        self.extra = extra

    def __call__(self, plan) -> None:
        import dataclasses
        from yoloface_tpu_torch.kernels import fused
        for k, st in enumerate(plan.stages):
            plan.stages[k] = dataclasses.replace(
                st, **({"scratch": st.scratch + self.extra}
                       if isinstance(st, fused.FusedStage)
                       else {"arena_bytes": st.arena_bytes + self.extra}))


def _spec(spec):
    """(knobs, substitutions, planner, launch fix) of a variant's spec."""
    knobs = next((v for v in spec if isinstance(v, dict)), {})
    subs = next((v for v in spec if isinstance(v, list)), [])
    marks = next((v for v in spec if isinstance(v, Marks)), Marks(None))
    fix = next((v for v in spec if isinstance(v, Smem)), None)
    return knobs, subs, marks, fix


def _planned(marks: Marks, build):
    """``build()`` with the variant's planner."""
    if marks.mark is None:
        return build()
    with marks:
        return build()


_VARIANTS = iter(range(200, 10 ** 6))      # a build directory each


def _build_all(variants, source: str, entry: str):
    """``variant_library`` of each variant (its knobs and substitutions),
    the builds run at once; -> [(library, entry, report)] in order."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = []
    for _, *spec in variants:
        knobs, subs, _, _ = _spec(spec)
        jobs.append((next(_VARIANTS), source, entry, _stage(**knobs) + subs))
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(lambda job: variant_library(*job), jobs))


def _sweep_stage(dev, variants, tag: str, kernel: str = "arena",
                 kinds: bool = False, mode: str = None) -> None:
    """Each variant of the arena (or fused) kernel: its registers and
    spills, the corpus net's stages at 16384 in each bit semantics, held
    against the plain version on 37 frames first, and the ``arena2`` (or
    ``fused``; or ``mode``) pipeline at 65536, every launch through the
    variant; with ``kinds``, also that pipeline's stage time by op kind at
    16384 (``tools/torch_profile_pipeline.py``'s descriptor prefix
    times)."""
    from yoloface_tpu_torch.kernels import arena, fused
    from yoloface_tpu_torch.pipeline.e2e import load_pipeline
    g = load_tflite(CORPUS)
    gen = torch.Generator(device=dev).manual_seed(0)
    if kernel == "arena":
        planner, bits_all = arena.ArenaPlan, arena.BITS
        run, plain = arena.arena_stage, arena.arena_stage_plain
    else:
        planner, bits_all = fused.FusedPlan, fused.BITS
        run, plain = fused.fused_stage, fused.fused_stage_plain
    mode = mode or {"arena": "arena2", "fused": "fused"}[kernel]
    x = torch.randint(-128, 128, (16384, 56, 56, 3), generator=gen,
                      device=dev, dtype=torch.int8)
    small = x[:37].contiguous()
    frames = torch.randint(-1 << 15, 1 << 15, (65536, 112, 112),
                           generator=gen, device=dev,
                           dtype=torch.int16).view(torch.uint16)
    lib = _build.library()
    entry_name = f"yf_{kernel}_stage"
    built = getattr(lib, entry_name)
    libs = _build_all(variants, f"{kernel}_stage.cu", entry_name)
    for (label, *spec), (vlib, entry, log) in zip(variants, libs):
        knobs, subs, marks, fix = _spec(spec)
        plans = _planned(marks, lambda: {
            b: planner(g, bits=b).to(dev) for b in bits_all})
        pipe = _planned(marks, lambda: load_pipeline(CORPUS, mode=mode,
                                                     device=dev))
        for p in [*plans.values(), pipe.engine.arena] if fix else ():
            fix(p)
        fn = getattr(vlib, entry)
        fn.argtypes = _build.SIGNATURES[entry_name]
        fn.restype = ctypes.c_int
        setattr(lib, entry_name, fn)     # every launch through it
        try:
            line = []
            for bits, p in plans.items():
                env = {p.input_idx: small}
                for j, st in enumerate(p.stages):
                    ins = [env[i] for i in st.inputs]
                    got = run(st, getattr(p, f"descs{j}"),
                              getattr(p, f"consts{j}"), ins)
                    want = [torch.empty_like(t) for t in got]
                    plain(st, getattr(p, f"consts{j}"), ins + want)
                    for u, v in zip(got, want):
                        same(u, v, f"{tag} {label} {bits} stage {j}")
                    env.update(zip(st.outputs, got))
                ms = time_ms(lambda p=p: p.run_stages(x), dev, 10)
                line.append(f"{bits} {ms:.4f}")
            ms = time_ms(lambda: pipe.detect_rgb565_device(frames), dev, 5)
            by = kinds and (prof.arena_breakdown if kernel == "arena" else
                            prof.fused_breakdown)(pipe, 16384, tag)
        finally:
            setattr(lib, entry_name, built)
        print(f"[sweep] {tag} {label}: {kernel} stages at 16384, ms: "
              f"{', '.join(line)}; {mode} pipeline at 65536 {ms:.3f} ms "
              f"({65536 / ms * 1e3:.0f} frames/s) (ptxas: "
              f"{_stage_report(log, f'{kernel}_stage_kernel')})"
              + (f"; {mode} stage by kind, ms: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in sorted(by.items()))
                 if by else ""), flush=True)


def _sweep_perop(dev, variants, tag: str, kernels) -> None:
    """Each variant of the fused-stage kernel on the corpus net's per-op
    programs of ``kernels`` (B8.3 ``conv3x3``, B8.5 ``maxpool_int8``) at
    16384, in fast and exact bits, each op held against its plain version
    on its timed inputs first, then timed in device time behind a spin and
    summed by kernel."""
    from yoloface_tpu_torch.kernels import perop
    g = load_tflite(CORPUS)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-128, 128, (16384, 56, 56, 3), generator=gen,
                      device=dev, dtype=torch.int8)
    lib = _build.library()
    built = lib.yf_fused_stage
    libs = _build_all(variants, "fused_stage.cu", "yf_fused_stage")
    for (label, *spec), (vlib, entry, log) in zip(variants, libs):
        knobs, subs, marks, fix = _spec(spec)
        fn = getattr(vlib, entry)
        fn.argtypes = _build.SIGNATURES["yf_fused_stage"]
        fn.restype = ctypes.c_int
        line = []
        for bits in perop.BITS:
            p = _planned(marks, lambda: perop.PerOpPlan(g, bits).to(dev))
            env = p.run_stages(x)
            if fix:
                fix(p)
            lib.yf_fused_stage = fn
            try:
                for name in kernels:
                    total = 0.0
                    for k, st in enumerate(p.stages):
                        if st.kernel != name:
                            continue
                        ins = [env[i] for i in st.inputs]

                        def op(k=k, st=st, ins=ins):
                            return perop.perop_op(
                                st, getattr(p, f"descs{k}"),
                                getattr(p, f"consts{k}"), ins)
                        want = torch.empty_like(env[st.outputs[0]])
                        perop.perop_plain(st, getattr(p, f"consts{k}"),
                                          ins + [want])
                        same(op()[0], want, f"{tag} {label} {bits} op {k}")
                        total += time_ms(op, dev, 10)
                    line.append(f"{name} {bits} {total:.4f}")
            finally:
                lib.yf_fused_stage = built
        print(f"[sweep] {tag} per-op {label}: ms at 16384: "
              f"{', '.join(line)} (ptxas: "
              f"{_stage_report(log, 'fused_stage_kernel')})", flush=True)


# The full-window conv body (stem_mma): the lane's 4 K positions, where
# they are one run of bytes of a window row inside the image, as one
# funnel-shifted word (load_word) instead of 4 byte loads
FUNNEL = [
    (STAGE, """      unsigned a[2] = {0u, 0u};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int dy, dx, c;""", """      unsigned a[2] = {0u, 0u};
      int ry, rx, rc, ey, ex, ec;
      const bool run =
          !words && cs == ci &&
          k_tap(k0, k_n, ci, kw, m_ci, m_kw, ry, rx, rc) &&
          k_tap(k0 + 3, k_n, ci, kw, m_ci, m_kw, ey, ex, ec) && ey == ry;
      bool done[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        done[h] = run && inside[h];
        if (done[h])
          a[h] = load_word(
              in + ((y0[h] + ry) * in_w + x0[h] + rx) * cs + rc, 4);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int dy, dx, c;"""),
    (STAGE, """          if (!live[h]) continue;
          const int iy = y0[h] + dy, ix = x0[h] + dx;""",
     """          if (!live[h] || done[h]) continue;
          const int iy = y0[h] + dy, ix = x0[h] + dx;""")]
# K padded to 16 a window row (the stem: 3 k16 steps, one a row, against
# 27 -> 32 in 2): the body's K positions and the planner's packing
ROW_K = [
    (STAGE, """  const int q = div_by(k, ci, m_ci);
  c = k - q * ci;
  dy = div_by(q, kw, m_kw);
  dx = q - dy * kw;
  return k < k_n;""", """  const int r16 = (kw * ci + 15) >> 4;        // k16 steps a window row
  dy = r16 == 1 ? k >> 4 : (k >> 4) / r16;
  const int r = k - ((dy * r16) << 4);
  dx = div_by(r, ci, m_ci);
  c = r - dx * ci;
  return r < kw * ci && k < k_n;"""),
    (STAGE, "  const int k_n = kh * kw * ci;                            // K",
     "  const int k_n = kh * (((kw * ci + 15) >> 4) << 4);      // K")]


def _row_k_mark(st):
    """``arena.mark_mma`` with each full window's K padded to 16 a window
    row (``ROW_K``'s packing)."""
    import dataclasses
    import numpy as np
    from yoloface_tpu_torch.kernels import arena
    F = arena.F
    descs = st.descs.copy()
    consts = bytearray(st.consts.tobytes())
    for d in descs:
        if d[F["code"]] != arena.CONV:
            continue
        co, kh, kw, ci = (int(d[F[k]]) for k in ("out_c", "kh", "kw",
                                                 "in0_c"))
        w0 = int(d[F["w_off"]])
        w = st.consts[w0:w0 + co * kh * kw * ci].view(np.int8).reshape(
            co, kh, kw * ci)
        row = -(-kw * ci // 16) * 16 if kh * kw > 1 else kw * ci
        wr = np.zeros((co, kh, row), np.int8)
        wr[:, :, :kw * ci] = w
        d[F[arena.FRAG_FIELD]] = arena.put_const(
            consts, arena.pack_frags(wr.reshape(co, 1, 1, kh * row)))
    return dataclasses.replace(st, descs=descs, consts=np.frombuffer(
        bytes(consts), np.uint8).copy())


# a per-op program's input view in device memory staged in shared memory
# (the 16-byte aligned range holding the frame's view, 16-byte loads, at
# the end of the dynamic shared memory) before a full conv reads it,
# against reading device memory directly
STAGE_FRAME = """namespace {

// the frame's input view staged at the end of the dynamic shared memory;
// -> the view there, at the same offset within 16 bytes
__device__ const int8_t* stage_frame(const yf::Op& op, const int8_t* in,
                                     int8_t* smem) {
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  const uintptr_t a = reinterpret_cast<uintptr_t>(in);
  const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
  const int n16 = static_cast<int>(
      (a + op.in0.h * op.in0.w * op.in0.cs - a0 + 15) >> 4);
  uint4* dst = reinterpret_cast<uint4*>(smem + ((dyn - 16u * n16) & ~15u));
  const uint4* src = reinterpret_cast<const uint4*>(a0);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  return reinterpret_cast<const int8_t*>(dst) + (a - a0);
}
"""
STAGED = [
    ("fused_stage.cu", "namespace {\n", STAGE_FRAME),
    ("fused_stage.cu", """    const int8_t* in0 = yf::base(op.in0, smem, g, frame);
""", """    const int8_t* in0 = yf::base(op.in0, smem, g, frame);
    if (op.in0.space != 0 && op.code == yf::CONV && op.frag_off != 0 &&
        op.kh * op.kw > 1)
      in0 = stage_frame(op, in0, smem);
""")]
# the per-op input the staged variant holds: the stem's 57x57x3
STAGED_BYTES = 57 * 57 * 3 + 32
# a per-op max-pool reading its input from device memory, against staged
# in shared memory first (stage_view)
POOL_DIRECT = [("fused_stage.cu", "        if (op.in0.space != 0) {",
                "        if (false) {")]
# the max-pool walking down the output rows (pool), against the row and
# column passes through a scratch: a thread owns an (output column,
# channel word) and keeps the horizontal maxima of the kh window rows in
# registers, shifting in sh new rows an output row; no scratch
WALK_BODY = r"""// the window rows the max-pool's register walk holds (the repo's graphs
// take 8x8 and 4x4 windows); a taller window takes the caller's other body
constexpr int kPoolRows = 8;

// MAX_POOL over the whole frame, four channels a thread (the caller
// guarantees op.kh <= kPoolRows).  A thread owns one (output column, word
// of 4 channels; the last word of a pixel holds c % 4 of them where 4 does
// not divide c) and walks down a band of output rows, the frame's rows cut
// into as many bands as the block has threads for.  It keeps the
// horizontal maxima of the kh input rows its window spans in registers
// (hm[kPoolRows - kh ..], newest last) and, from one output row to the
// next, shifts in the sh rows the window moves down by: each new row is kw
// word loads and __vmaxs4s, each output word kh __vmaxs4s, against
// maxpool_op's kh * kw byte loads an output byte.  Words at any byte
// alignment (cs = 18, a view one byte in) are funnel-shifted from aligned
// loads (load_word).  Same compares, same fill: the bits are maxpool_op's.
static __device__ void maxpool_walk_op(const Op& op, const int8_t* in,
                                        int8_t* out) {
  const int c_n = op.out.c, nq = (c_n + 3) >> 2, ow = op.out.w;
  const int oh = op.out.h, kh = op.kh, cols = ow * nq;
  const int bands = max(1, min(oh, static_cast<int>(blockDim.x) / cols));
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  for (int e = threadIdx.x; e < cols * bands; e += blockDim.x) {
    const int q = e % nq, r = e / nq, ox = r % ow, band = r / ow;
    const int c = 4 * q, n = min(4, c_n - c);
    const int x0 = ox * op.sw - op.pl;
    const int oy0 = band * oh / bands, oy1 = (band + 1) * oh / bands;
    int iy = oy0 * op.sh - op.pt;            // the next input row to take
    unsigned hm[kPoolRows] = {};
#pragma unroll
    for (int j = 0; j < kPoolRows; ++j)
      if (j >= kPoolRows - kh)
        hm[j] = pool_row(op, in, iy++, x0, c, n, fill);
    for (int oy = oy0; oy < oy1; ++oy) {
      if (oy > oy0) {
        for (int k = 0; k < op.sh; ++k) {
#pragma unroll
          for (int j = 0; j + 1 < kPoolRows; ++j) hm[j] = hm[j + 1];
          hm[kPoolRows - 1] = pool_row(op, in, iy++, x0, c, n, fill);
        }
      }
      unsigned m = hm[kPoolRows - 1];
#pragma unroll
      for (int j = 0; j + 1 < kPoolRows; ++j)
        if (j >= kPoolRows - kh) m = __vmaxs4(m, hm[j]);
      int8_t* o = out + (oy * ow + ox) * op.out.cs + c;
      if (n == 4 && (addr(o) & 3) == 0) {
        *reinterpret_cast<unsigned*>(o) = m;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < n) o[b] = static_cast<int8_t>(m >> (8 * b));
      }
    }
  }
}

"""
WALK = [
    (STAGE, "// A whole-frame kernel as the build compiled it",
     WALK_BODY + "// A whole-frame kernel as the build compiled it"),
    ("arena_stage.cu", """          yf::maxpool_words_op(
              op, in0, out, reinterpret_cast<unsigned*>(arena + scratch_off));""",
     "          yf::maxpool_walk_op(op, in0, out);"),
    ("fused_stage.cu", """        yf::maxpool_words_op(op, in0, out,
                             reinterpret_cast<unsigned*>(scratch));""",
     "        yf::maxpool_walk_op(op, in0, out);")]
# a body compiled as a function of its own (its registers allocated apart
# from the kernel's other bodies), against inlined
NOINLINE_CONV = [(STAGE, "static __device__ void conv_mma_body(",
                  "static __device__ __noinline__ void conv_mma_body(")]
NOINLINE_POOL = [(STAGE, "static __device__ void maxpool_words_op(",
                  "static __device__ __noinline__ void maxpool_words_op(")]
# the full-window body's 4 K positions of a step taken one at a time (the
# loop over them not unrolled: fewer taps live at once)
B_LOOP = [(STAGE, """#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int dy, dx, c;""", """#pragma unroll 1
      for (int b = 0; b < 4; ++b) {
        int dy, dx, c;""")]
# the word passes with a thread's (output column, channel word) fixed and
# its rows strided (one division a thread, not two an item)
POOL_COLS_BODY = r"""static __device__ void maxpool_words_op(const Op& op, const int8_t* in,
                                        int8_t* out, unsigned* scratch) {
  const int c_n = op.out.c, nq = (c_n + 3) >> 2, ow = op.out.w;
  const int oh = op.out.h, n_rows = (oh - 1) * op.sh + op.kh;
  const int cols = ow * nq;               // (output column, word) pairs
  const int step = max(1, static_cast<int>(blockDim.x) / cols);
  const unsigned fill =
      static_cast<unsigned>(static_cast<uint8_t>(op.fill)) * 0x01010101u;
  for (int e = threadIdx.x; e < cols * step; e += blockDim.x) {
    const int col = e % cols, r0 = e / cols, q = col % nq, ox = col / nq;
    const int n = min(4, c_n - 4 * q), x0 = ox * op.sw - op.pl;
    for (int row = r0; row < n_rows; row += step)
      scratch[row * cols + col] =
          pool_row(op, in, row - op.pt, x0, 4 * q, n, fill);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cols * step; e += blockDim.x) {
    const int col = e % cols, r0 = e / cols, q = col % nq, ox = col / nq;
    const int n = min(4, c_n - 4 * q);
    for (int oy = r0; oy < oh; oy += step) {
      const unsigned* v = scratch + oy * op.sh * cols + col;
      unsigned m = v[0];
      for (int dy = 1; dy < op.kh; ++dy) m = __vmaxs4(m, v[dy * cols]);
      int8_t* o = out + (oy * ow + ox) * op.out.cs + 4 * q;
      if (n == 4 && (addr(o) & 3) == 0) {
        *reinterpret_cast<unsigned*>(o) = m;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < n) o[b] = static_cast<int8_t>(m >> (8 * b));
      }
    }
  }
}

"""
POOL_COLS = [_replace_body("static __device__ void maxpool_words_op(",
                           "// The shared memory stage_view takes",
                           POOL_COLS_BODY)]
STEM_ARENA_VARIANTS = [
    ("as built (K 27 -> 32, byte gathers; v2 compiled in the full-window "
     "body)", {}),
    ("funnel-shifted words", FUNNEL),
    ("K padded to 16 a window row", ROW_K, Marks(_row_k_mark)),
    ("a step's K positions one at a time", B_LOOP),
    ("no epilogue compiled in the full-window body",
     dict(kArenaConvEpis="0")),
    ("the fast epilogues compiled in the full-window body",
     dict(kArenaConvEpis="kFastEpis")),
    ("every epilogue compiled in the full-window body",
     dict(kArenaConvEpis=f"kFastEpis | {EXACT_EPIS}")),
    ("the full-window body not inlined", NOINLINE_CONV),
]
STEM_FUSED_VARIANTS = [
    ("as built (v1 compiled in the full-window body)", {}),
    ("K padded to 16 a window row", ROW_K, Marks(_row_k_mark)),
    ("a step's K positions one at a time", B_LOOP),
    ("no epilogue compiled in the full-window body",
     dict(kFusedConvEpis="0")),
    ("the fast epilogues compiled in the full-window body",
     dict(kFusedConvEpis=V1_EPIS)),
    ("every epilogue compiled in the full-window body",
     dict(kFusedConvEpis=f"{V1_EPIS} | {EXACT_EPIS}")),
]
STEM_PEROP_VARIANTS = [
    ("as built (device memory read directly, byte gathers)", {}),
    ("funnel-shifted words", FUNNEL),
    ("K padded to 16 a window row", ROW_K, Marks(_row_k_mark)),
    ("staged in shared memory", STAGED, Smem(STAGED_BYTES)),
]
POOL_VARIANTS = [
    ("as built (row and column passes on words through a scratch)", {}),
    ("walking down the rows, the window rows in registers", WALK),
    ("passes by column", POOL_COLS),
    ("the word passes not inlined", NOINLINE_POOL),
]
POOL_PEROP_VARIANTS = [
    ("as built (the input staged in shared memory, row and column "
     "passes)", {}),
    ("device memory read directly", POOL_DIRECT),
    ("walking down the rows, the window rows in registers", WALK),
    ("passes by column", POOL_COLS),
]

# The full-window body on every marked conv (bodies): conv_mma_body for
# the 1x1s too, with the 1x1 body's epilogue set or the full-window
# body's, against conv1x1_mma_body beside it; and the kernels with the
# full-window body and the max-pool word passes compiled out (the stem
# unmarked on conv_op, the max-pools on maxpool_op), which the op kinds'
# times (kinds) hold against the kernel as built
MARKED_CONV = """  if (op.kh == 1 && op.kw == 1)
    by_epilogue<kEpis1x1, kOnly>(op.epi, Conv1x1Mma{op, in, out, consts});
  else
    by_epilogue<kEpisFull, kOnly>(op.epi, ConvMma{op, in, out, consts});"""
FULL_1X1_SET = [(STAGE, MARKED_CONV, """  by_epilogue<kEpis1x1, kOnly>(op.epi,
                               ConvMma{op, in, out, consts});""")]
FULL_FULL_SET = [(STAGE, MARKED_CONV, """  by_epilogue<kEpisFull, kOnly>(op.epi,
                                ConvMma{op, in, out, consts});""")]
NO_FULL = [(STAGE, MARKED_CONV, """  by_epilogue<kEpis1x1, kOnly>(op.epi,
                               Conv1x1Mma{op, in, out, consts});""")]
MARK_MMA = arena.mark_mma


def _mark_1x1(st):
    """``arena.mark_mma`` with only the 1x1 CONVs marked (the full
    windows' fragments appended but not named)."""
    st = MARK_MMA(st)
    F = arena.F
    for d in st.descs:
        if d[F["kh"]] * d[F["kw"]] > 1:
            d[F[arena.FRAG_FIELD]] = 0
    return st


ARENA_NEW_OUT = NO_FULL + [("arena_stage.cu", """        if (scratch_off != 0)
          yf::maxpool_words_op(""", """        if (false)
          yf::maxpool_words_op(""")]
FUSED_NEW_OUT = NO_FULL + [("fused_stage.cu", """        yf::maxpool_words_op(op, in0, out,
                             reinterpret_cast<unsigned*>(scratch));""",
                            "        yf::maxpool_op(op, in0, 0, out, 0, "
                            "op.out.h);")]
BODIES_ARENA_VARIANTS = [
    ("as built (1x1s on conv1x1_mma_body)", {}),
    ("the full-window body on every marked conv, the 1x1 body's epilogues",
     FULL_1X1_SET),
    ("the full-window body on every marked conv, its own epilogues",
     FULL_FULL_SET),
    ("the full-window body and the word passes compiled out",
     ARENA_NEW_OUT, Marks(_mark_1x1)),
    ("as built, again", {}),
]
BODIES_FUSED_VARIANTS = [
    ("as built (1x1s on conv1x1_mma_body)", {}),
    ("the full-window body on every marked conv, the 1x1 body's epilogues",
     FULL_1X1_SET),
    ("the full-window body on every marked conv, its own epilogues",
     FULL_FULL_SET),
    ("the full-window body and the word passes compiled out",
     FUSED_NEW_OUT, Marks(_mark_1x1)),
    ("as built, again", {}),
]
BODIES_PEROP_VARIANTS = BODIES_FUSED_VARIANTS[:4]


def sweep_bodies(dev) -> None:
    _sweep_stage(dev, BODIES_ARENA_VARIANTS, "bodies", kinds=True)
    _sweep_stage(dev, BODIES_FUSED_VARIANTS, "bodies", "fused", kinds=True)
    _sweep_perop(dev, BODIES_PEROP_VARIANTS, "bodies",
                 ("conv1x1", "conv3x3", "dwconv3x3", "maxpool_int8"))


def sweep_stem_mma(dev) -> None:
    _sweep_stage(dev, STEM_ARENA_VARIANTS, "stem_mma")
    _sweep_stage(dev, STEM_FUSED_VARIANTS, "stem_mma", "fused")
    _sweep_perop(dev, STEM_PEROP_VARIANTS, "stem_mma", ("conv3x3",))


def sweep_pool(dev) -> None:
    _sweep_stage(dev, POOL_VARIANTS, "pool")
    _sweep_stage(dev, POOL_VARIANTS, "pool", "fused")
    _sweep_perop(dev, POOL_PEROP_VARIANTS, "pool", ("maxpool_int8",))


def sweep_arena_mma(dev) -> None:
    _sweep_stage(dev, ARENA_MMA_VARIANTS, "arena_mma")


def sweep_dw4(dev) -> None:
    _sweep_stage(dev, DW4_VARIANTS, "dw4")


def sweep_fused_mma(dev) -> None:
    _sweep_stage(dev, FUSED_MMA_VARIANTS, "fused_mma", "fused")


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
              f"{_stage_report(log, kernel_name(entry))})", flush=True)


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


# The exact epilogues of the whole-frame kernels (B3 in B2, B7 and the
# per-op programs): the exact instantiation as built (kExactEpis in every
# body, the fused leaky's half from the op's table, mbqm32) against the
# leaky by a second MBQM, the 64-bit MBQM, both (the arithmetic PR 14 had,
# in the exact instantiation), the exact epilogues compiled into the fast
# instantiation (one kernel, no second), PR 14's form (one kernel, the
# exact epilogues at run time), and the fast v1 leaky by its second
# rounding in floats instead of the table.
ONE_KERNEL = {"arena": [("arena_stage.cu", "  auto kernel = exact ? "
                         "arena_stage_kernel<true> : arena_stage_kernel<false>;",
                         "  auto kernel = arena_stage_kernel<false>;")],
              "fused": [("fused_stage.cu", "  auto kernel = exact ? "
                         "fused_stage_kernel<true> : fused_stage_kernel<false>;",
                         "  auto kernel = fused_stage_kernel<false>;")]}
V1_TABLE = "1u << EPI_LEAKY_V1"          # the exact leaky by arithmetic
EXACT_TABLE = "1u << EPI_LEAKY_EXACT"    # the v1 leaky by arithmetic


def _exact_epi_variants(kernel: str):
    k = "Arena" if kernel == "arena" else "Fused"
    sets = {f"k{k}{b}Epis": f"{STAGE_BUILT[f'k{k}{b}Epis'][1]} | kExactEpis"
            for b in ("Mma", "Conv", "Dw")}
    return [
        ("as built (the exact instantiation, the leaky from the op's table, "
         "mbqm32; the v1 leaky from a table)", {}),
        ("the leaky by a second MBQM", dict(kTableEpis=V1_TABLE)),
        ("the 64-bit MBQM", dict(kMbqm32="false")),
        ("the leaky by a second MBQM, the 64-bit MBQM",
         dict(kTableEpis=V1_TABLE, kMbqm32="false")),
        ("one kernel: the exact epilogues compiled into the fast "
         "instantiation", sets, ONE_KERNEL[kernel]),
        ("one kernel, the exact epilogues at run time (PR 14's form)",
         ONE_KERNEL[kernel]),
        ("the v1 leaky by its second rounding in floats",
         dict(kTableEpis=EXACT_TABLE)),
        ("as built, again", {}),
    ]


def sweep_exact_epi(dev) -> None:
    _sweep_stage(dev, _exact_epi_variants("arena"), "exact_epi",
                 mode="arena_exact")
    _sweep_stage(dev, _exact_epi_variants("fused"), "exact_epi", "fused",
                 mode="fused_exact")
    _sweep_perop(dev, _exact_epi_variants("fused"), "exact_epi",
                 ("conv1x1", "conv3x3", "dwconv3x3"))


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
                  f"{', '.join(line)} (ptxas: {_stage_report(log, kernel)})",
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
              "mma_body": sweep_mma_body, "arena_mma": sweep_arena_mma,
              "dw4": sweep_dw4, "fused_mma": sweep_fused_mma,
              "stem_mma": sweep_stem_mma, "pool": sweep_pool,
              "bodies": sweep_bodies, "add": sweep_add,
              "quantize": sweep_quantize, "exact_epi": sweep_exact_epi,
              "head": sweep_head}
    for name in argv or list(sweeps):
        sweeps[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
