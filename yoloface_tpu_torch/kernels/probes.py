"""Kernel wrappers of the tools/ probes (B9) and their plain versions.

The JAX package's probes under ``tools/`` (``microbench.py``,
``probe448_micro.py``, ``probe448.py``, ``debug448_{fix,rep,min}.py``) have
Pallas kernels of their own.  Their counterparts here:

* ``probe_copy`` / ``probe_phase_select`` (``csrc/probe_copy.cu``): identity
  copies (the whole tensor, a block a frame, a block a frame x strip) and
  the stride-2 select ``x[:, ::2]``;
* ``probe_dw`` / ``probe_requant_chain`` (``csrc/probe_dw.cu``): depthwise
  3x3 taps (NHWC or frames innermost, offsets or none, stride 1 or 2, an
  int8 or int32 input, ``>> 7``, fast or exact requant or the raw sum, int32
  or 16-bit arithmetic, R repetitions) one thread an output, and the fast
  requant chain; ``probe_dw(..., form="frames")``
  (``csrc/probe_dw_frames.cu``): the int8 NHWC taps a block a group of
  whole frames staged in shared memory (``dw_frames_plan``);
  ``probe_dw(..., layout="fi", form="fi_mma")``
  (``csrc/probe_dw_fi_mma.cu``): the frame-innermost taps R times on the
  int8 tensor cores, 2 x 2 outputs a product, a warp a channel, a pair of
  output rows and 64 frames;
* ``probe_conv`` (``csrc/probe_conv.cu``): a 1x1 conv as the CUDA-core loop,
  ``__dp4a`` or ``mma.sync`` on int8 (or bf16) tiles in shared memory, or
  frame innermost; int32 sums, ``clip(acc >> 7)`` with the rest of the
  channels copied, or ``int8(acc)`` wrapping; ``variant="fi_mma"``
  (``csrc/probe_fi_mma.cu``): the frame-innermost 1x1 on the int8 tensor
  cores, a warp a pixel and 64 frames; ``variant="mma_rows"``
  (``csrc/probe_nhwc_mma.cu``): the NHWC 1x1 on the int8 tensor cores,
  slabs of rows streamed once through shared memory, any K up to 64 and
  Nout up to 144 (``mma_rows_plan``), walked by persistent blocks or in
  runs of ``slabs_per_block`` slabs (``csrc/probe_nhwc_mma_runs.cu``).

Each wrapper checks its tensors, runs the plain version (beside it, named
``*_plain``) on a CPU tensor, launches its kernel on PyTorch's current
stream for a CUDA tensor (no synchronisation) and raises on any other
device; each counts its launches in ``.launches`` (and the Hopper forms
in ``probe_dw.frames_launches``, ``probe_dw.fi_mma_launches``,
``probe_conv.fi_mma_launches`` and ``probe_conv.mma_rows_launches`` as
well).  A form that cannot take its arguments raises; no wrapper falls
back to another form.  The plain versions compute in int64 or exact
float64 and repeat the kernels' arithmetic, the R-times forms as the JAX probes define them: the 1x1's
int8 weights plus r wrap to int8 (JAX's int8 ``w + r``), the int32 taps
plus r do not (the closed sum ``sum_r (t + r) = R*t + R*(R-1)/2``); sums
wrap to int16 or int8 where the kernel's store wraps.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from yoloface_tpu_torch.core.fixedpoint import requant_exact

COPY_SCHEDULES = ("flat", "frame", "strip")
DW_EPIS = ("shift", "fast", "exact", "raw")
DW_BORDERS = ("copy", "zero", "none")
# probe_dw's kernels: one thread an output element (PR 7's, every case),
# a block a group of whole int8 NHWC frames (csrc/probe_dw_frames.cu), the
# frame-innermost raw taps on the tensor cores (csrc/probe_dw_fi_mma.cu)
DW_FORMS = ("thread", "frames", "fi_mma")
LAYOUTS = ("nhwc", "fi")           # fi: frames innermost, [H, W, C, N]
CONV_VARIANTS = ("loop", "imad", "dp4a", "mma", "mma_bf16", "fi", "fi4",
                 "fi_mma", "mma_rows")
CONV_EPIS = ("raw", "shift", "wrap")
FRAME_INNER = ("fi", "fi4", "fi_mma")
SMEM_LIMIT = 232448                # bytes of shared memory a block may have
# csrc/probe_dw_frames.cu: 256 threads, three groups of frames in flight
# and an output group in shared memory, two blocks an SM (each block's
# shared memory less the 1 KB the card reserves a block)
DW_THREADS, DW_STAGES = 256, 3
DW_BLOCK_SMEM = SMEM_LIMIT // 2 - 1024
# csrc/probe_fi_mma.cu: a warp task is one pixel and 64 frames; K and Nout
# padded to 64 and a multiple of 8 (two m16n8k32 k-steps, four n-tiles)
FI_FRAMES, FI_MAX_K, FI_MAX_NOUT = 64, 64, 32
# csrc/probe_nhwc_mma.cu: slabs of 256 rows (a warp 64), a ring of 2-4
# slabs, the RAW and WRAP outputs through one slab buffer; K up to 64
# (chunks of 16), Nout up to 144 (n-tiles of 8; where K is not a multiple
# of 4 or Nout passes ROWS_FAST_NOUT, csrc/probe_nhwc_mma_any.cu's kernel,
# the n-tiles in groups of at most ROWS_GROUP)
ROWS_SLAB, ROWS_MAX_STAGES, ROWS_MAX_K, ROWS_MAX_NOUT = 256, 4, 64, 144
ROWS_FAST_NOUT, ROWS_GROUP = 64, 8
SM_SMEM = 233472                   # bytes of shared memory an SM has
ROWS_BLOCK_SMEM = SM_SMEM // 3 - 1024         # three blocks an SM
TM = TN = 64                       # probe_conv.cu's tile
_SKEW = {"imad": 4, "dp4a": 4, "mma": 16, "mma_bf16": 8}
# the dw kernel's instances: (layout, input, output, arithmetic)
_DW_CASES = {("nhwc", torch.int8, torch.int8, "i32"),
             ("nhwc", torch.int32, torch.int32, "i32"),
             ("nhwc", torch.int8, torch.int32, "i32"),
             ("fi", torch.int8, torch.int8, "i32"),
             ("fi", torch.int8, torch.int32, "i32"),
             ("fi", torch.int8, torch.int16, "i16")}


def _device(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return x.device.type


def _tensor(x: torch.Tensor, what: str, dtypes, dim: Optional[int] = None
            ) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype not in dtypes:
        raise ValueError(f"{what}: expected a {'/'.join(map(str, dtypes))} "
                         f"tensor, got {getattr(x, 'dtype', type(x))}")
    if dim is not None and x.dim() != dim:
        raise ValueError(f"{what}: expected {dim} dimensions, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.numel() >= 1 << 31:
        raise ValueError(f"{what}: {x.numel()} elements pass int32 indices")


def _launch(fn: str, what: str, *ptrs_then_params, device) -> None:
    from yoloface_tpu_torch.kernels._build import PROBES, check, library
    *ptrs, params = ptrs_then_params
    arr = (ctypes.c_int * len(params))(*[int(v) for v in params])
    err = getattr(library(PROBES), fn)(*ptrs, arr,
                                 torch.cuda.current_stream(device).cuda_stream)
    check(err, what)


def _aligned(*ts: torch.Tensor, to: int = 16) -> bool:
    return all(t.data_ptr() % to == 0 for t in ts)


# --------------------------------------------------------------------------
# copies
# --------------------------------------------------------------------------
def probe_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def probe_copy(x: torch.Tensor, schedule: str = "flat",
               strips: int = 1) -> torch.Tensor:
    """An identity copy of int8 ``x`` (frames on dim 0): ``flat`` walks the
    whole tensor, ``frame`` takes one block a frame, ``strip`` one block a
    frame x strip (``strips`` equal byte ranges of a frame: its row strips
    for NHWC)."""
    _tensor(x, "probe_copy", (torch.int8,))
    if schedule not in COPY_SCHEDULES:
        raise ValueError(f"unknown copy schedule {schedule!r}; one of "
                         f"{COPY_SCHEDULES}")
    if x.dim() < 1:
        raise ValueError("probe_copy: expected frames on dim 0")
    n = x.shape[0]
    frame = x.numel() // max(n, 1)
    if schedule == "strip" and (strips < 1 or frame % strips or n > 65535):
        raise ValueError(f"probe_copy: {frame} B frames in {strips} strips "
                         f"of {n} frames")
    if _device(x, "probe_copy") == "cpu":
        return probe_copy_plain(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows = {"flat": (1, 1, x.numel()), "frame": (n, 1, frame),
            "strip": (strips, n, frame // max(strips, 1))}[schedule]
    vec = _aligned(x, out) and (schedule == "flat" or rows[2] % 16 == 0)
    _launch("yf_probe_copy", "probe_copy", x.data_ptr(), out.data_ptr(),
            (int(schedule != "flat"), *rows, rows[2], int(vec)),
            device=x.device)
    probe_copy.launches += 1
    return out


probe_copy.launches = 0


def probe_phase_select_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, ::2].contiguous()


def probe_phase_select(x: torch.Tensor) -> torch.Tensor:
    """int8 ``x`` [N, W, ...] -> ``x[:, ::2]``: the even positions of dim 1
    (probe448_micro probe A's even-W phase)."""
    _tensor(x, "probe_phase_select", (torch.int8,))
    if x.dim() < 2 or x.shape[0] > 65535 or x.shape[1] % 2:
        raise ValueError(f"probe_phase_select: expected [N <= 65535, even W,"
                         f" ...], got {tuple(x.shape)}")
    if _device(x, "probe_phase_select") == "cpu":
        return probe_phase_select_plain(x)
    n, w = x.shape[:2]
    out = torch.empty((n, w // 2, *x.shape[2:]), dtype=torch.int8,
                      device=x.device)
    if out.numel() == 0:
        return out
    row = x.numel() // (n * w)
    vec = _aligned(x, out) and row % 16 == 0
    _launch("yf_probe_copy", "probe_phase_select", x.data_ptr(),
            out.data_ptr(), (1, w // 2, n, row, 2 * row, int(vec)),
            device=x.device)
    probe_phase_select.launches += 1
    return out


probe_phase_select.launches = 0


# --------------------------------------------------------------------------
# depthwise taps and the requant chain
# --------------------------------------------------------------------------
def _dw_args(x, taps, so, layout, stride, offs, origin, border, epi, scale,
             arith, form="thread", reps=1):
    """Check probe_dw's arguments -> (n, sp, c, output spatial size,
    output dtype)."""
    _tensor(x, "probe_dw x", (torch.int8, torch.int32), 4)
    _tensor(taps, "probe_dw taps", (torch.int32,), 2)
    if layout not in LAYOUTS or epi not in DW_EPIS or border not in DW_BORDERS:
        raise ValueError(f"probe_dw: layout {layout!r}, epi {epi!r}, border "
                         f"{border!r}")
    if layout == "nhwc":
        n, sp, sp2, c = x.shape
    else:
        sp, sp2, c, n = x.shape
    if sp != sp2 or tuple(taps.shape) != (9, c):
        raise ValueError(f"probe_dw: square frames and [9, C] taps, got "
                         f"{tuple(x.shape)} and {tuple(taps.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"probe_dw: stride {stride}")
    osp = so if border == "none" else sp
    if (so < 1 or (border == "none" and origin) or origin < 0
            or origin + so > osp
            or (so - 1) * stride + (2 if offs else 0) >= sp):
        raise ValueError(f"probe_dw: a {so}x{so} region at {origin} of a "
                         f"{sp}x{sp} input")
    if epi == "fast":
        _tensor(scale, "probe_dw scale", (torch.float32,), 1)
        if scale.numel() != c:
            raise ValueError("probe_dw: scale must be float32 [C]")
    if arith not in ("i32", "i16") or (arith == "i16" and epi != "raw"):
        raise ValueError(f"probe_dw: {arith} arithmetic with epi {epi}")
    out_dtype = ({"i32": torch.int32, "i16": torch.int16}[arith]
                 if epi == "raw" else x.dtype)
    if (layout, x.dtype, out_dtype, arith) not in _DW_CASES:
        raise ValueError(f"probe_dw: no kernel for {layout} {x.dtype} -> "
                         f"{out_dtype} in {arith}")
    if form not in DW_FORMS:
        raise ValueError(f"probe_dw: form {form!r}, one of {DW_FORMS}")
    if form == "fi_mma" and (layout != "fi" or x.dtype != torch.int8
                             or epi != "raw" or border != "none"
                             or stride != 1 or not offs or origin):
        raise ValueError("probe_dw fi_mma: int8 frames innermost, the raw "
                         "sum, no border, offsets, stride 1")
    if form == "frames":
        if (layout != "nhwc" or x.dtype != torch.int8 or epi == "raw"
                or border == "none" or reps != 1):
            raise ValueError("probe_dw frames: int8 NHWC in and out, a "
                             "shift, fast or exact epilogue, the border "
                             "copied or zeroed, one repetition")
        if c % 4 or (sp * sp * c) % 16:
            raise ValueError(f"probe_dw frames: C = {c} a multiple of 4 and "
                             f"frames of a multiple of 16 bytes")
        tensors = [x, taps] + ([scale] if epi == "fast" else [])
        if not _aligned(*tensors):
            raise ValueError("probe_dw frames: x, taps and scale must be "
                             "16-byte aligned")
        dw_frames_plan(sp, c, so, stride, offs)
    return n, sp, c, osp, out_dtype


def dw_frames_plan(sp: int, c: int, so: int, stride: int = 1,
                   offs: bool = True) -> dict:
    """The frames kernel's plan for int8 [N, sp, sp, c] frames and an so x
    so corner: ``frames`` a group (a block stages ``DW_STAGES`` groups and
    an output group in ``smem`` bytes), each corner row in ``segs`` runs of
    ``run`` outputs, a thread walking one (frame, row, run, channel word).
    Chooses the run length that keeps the most of a block's threads busy,
    less the columns a run loads before its first output (two at stride 1,
    one at stride 2)."""
    fb = sp * sp * c
    cap = DW_BLOCK_SMEM // ((DW_STAGES + 1) * fb)
    if cap < 1:
        if (DW_STAGES + 1) * fb > SMEM_LIMIT:
            raise ValueError(f"probe_dw frames: a {fb} B frame passes a "
                             "block's shared memory")
        cap = 1
    words = c // 4
    lead = 0 if not offs else 3 - stride
    best = None
    for segs in range(1, so + 1):
        run = -(-so // segs)
        if (segs - 1) * run >= so:      # a run left empty: the same as fewer
            continue
        per = so * segs * words
        frames = max(1, min(cap, DW_THREADS // per))
        items = frames * per
        busy = items / (DW_THREADS * -(-items // DW_THREADS))
        score = busy * stride * run / (stride * run + lead)
        if best is None or score > best[0] + 1e-12:
            best = (score, frames, run, segs)
    _, frames, run, segs = best
    return dict(frames=frames, run=run, segs=segs,
                smem=(DW_STAGES + 1) * frames * fb)


def probe_dw_plain(x, taps, *, so, layout="nhwc", stride=1, offs=True,
                   origin=0, border="copy", epi="shift", scale=None, qm=0,
                   shift=0, reps=1, arith="i32", form="thread"):
    n, sp, c, osp, out_dtype = _dw_args(x, taps, so, layout, stride, offs,
                                        origin, border, epi, scale, arith,
                                        form, reps)
    v = x if layout == "nhwc" else x.permute(3, 0, 1, 2)     # NHWC view
    v64 = v.to(torch.int64)
    w = reps * taps.to(torch.int64) + reps * (reps - 1) // 2  # sum_r w + r
    span = stride * (so - 1) + 1
    acc = torch.zeros((n, so, so, c), dtype=torch.int64, device=x.device)
    for k in range(9):
        dy, dx = (k // 3, k % 3) if offs else (0, 0)
        acc += v64[:, dy:dy + span:stride, dx:dx + span:stride] * w[k]
    if epi == "shift":
        r = (acc >> 7).clamp(-128, 127)
    elif epi == "fast":
        r = torch.round(acc.to(torch.float32) * scale).clamp(-128, 127)
    elif epi == "exact":
        r = requant_exact(acc, qm, shift, 0)
    else:
        r = acc
    r = r.to(torch.int32).to(out_dtype)       # int16: wraps mod 2**16
    if border == "none":
        out = r
    else:
        out = (v.to(out_dtype).clone() if border == "copy" else
               torch.zeros((n, osp, osp, c), dtype=out_dtype, device=x.device))
        out[:, origin:origin + so, origin:origin + so] = r
    return out if layout == "nhwc" else out.permute(1, 2, 3, 0).contiguous()


def probe_dw(x, taps, *, so, layout="nhwc", stride=1, offs=True, origin=0,
             border="copy", epi="shift", scale=None, qm=0, shift=0, reps=1,
             arith="i32", form="thread"):
    """Depthwise 3x3 taps of ``x`` (int8 or int32 [N, SP, SP, C] for
    ``nhwc``, [SP, SP, C, N] for ``fi``) with int32 ``taps`` [9, C]: the
    ``so`` x ``so`` outputs at (``origin``, ``origin``), tap k = 3*dy + dx
    reading input (y*stride + dy, x*stride + dx) (or (y*stride, x*stride)
    with ``offs`` False), summed over ``reps`` repetitions of the taps plus
    r; then ``clip(acc >> 7)``, ``clip(round(acc * scale[c]))`` (float32),
    ``clip(MBQM(acc, qm, shift))`` or the raw sum (int32, or int16 wrapped
    with ``arith="i16"``, which the kernel computes with 16-bit operands).
    The rest of the output is the input (``border="copy"``), zeros
    (``"zero"``) or absent (``"none"``: the output is so x so).
    ``form="thread"``: PR 7's kernel, one thread an output element, every
    case; ``"frames"``: the int8 NHWC cases with one repetition, C a
    multiple of 4, frames of a multiple of 16 bytes and 16-byte aligned
    tensors, a block a group of whole frames (``dw_frames_plan``);
    ``"fi_mma"``: int8 ``fi`` frames, the raw sum in either arithmetic, no
    border, offsets, stride 1, any R, on the int8 tensor cores (a channel
    with a tap past int8 less R - 1 on an int32 body of the same
    kernel)."""
    n, sp, c, osp, out_dtype = _dw_args(x, taps, so, layout, stride, offs,
                                        origin, border, epi, scale, arith,
                                        form, reps)
    kw = dict(so=so, layout=layout, stride=stride, offs=offs, origin=origin,
              border=border, epi=epi, scale=scale, qm=qm, shift=shift,
              reps=reps, arith=arith, form=form)
    if _device(x, "probe_dw") == "cpu":
        return probe_dw_plain(x, taps, **kw)
    if reps < 1 or taps.device != x.device or (
            epi == "fast" and scale.device != x.device):
        raise ValueError("probe_dw: reps >= 1, taps and scale on x's device")
    shape = (n, osp, osp, c) if layout == "nhwc" else (osp, osp, c, n)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if form == "frames":
        plan = dw_frames_plan(sp, c, so, stride, offs)
        params = (n, sp, c, so, origin, stride, int(offs),
                  DW_EPIS.index(epi), qm, shift, DW_BORDERS.index(border),
                  plan["frames"], plan["run"], plan["segs"])
        _launch("yf_probe_dw_frames", "probe_dw frames", x.data_ptr(),
                taps.data_ptr(), scale.data_ptr() if epi == "fast" else None,
                out.data_ptr(), params, device=x.device)
        probe_dw.frames_launches += 1
    elif form == "fi_mma":
        vec = n % 8 == 0 and _aligned(x, to=8) and _aligned(out)
        _launch("yf_probe_dw_fi_mma", "probe_dw fi_mma", x.data_ptr(),
                taps.data_ptr(), out.data_ptr(),
                (n, sp, c, so, reps, int(arith == "i16"), int(vec)),
                device=x.device)
        probe_dw.fi_mma_launches += 1
    else:
        params = (0, int(layout == "fi"), x.element_size(),
                  out.element_size(), int(arith == "i16"), n, sp, c, so, osp,
                  origin, stride, int(offs), DW_EPIS.index(epi), qm, shift,
                  DW_BORDERS.index(border), reps)
        _launch("yf_probe_dw", "probe_dw", x.data_ptr(), taps.data_ptr(),
                scale.data_ptr() if epi == "fast" else None, out.data_ptr(),
                params, device=x.device)
    probe_dw.launches += 1
    return out


probe_dw.launches = 0
probe_dw.frames_launches = 0
probe_dw.fi_mma_launches = 0


def _chain_scales(reps: int):
    """float32(1e-4 * (r + 1)): the Python double rounded once to float32,
    as JAX's weak typing gives it."""
    return [np.float32(1e-4 * (r + 1)) for r in range(reps)]


def probe_requant_chain_plain(x: torch.Tensor, reps: int = 16
                              ) -> torch.Tensor:
    v = (x.to(torch.int32) * 1000).to(torch.float32)
    s = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for f in _chain_scales(reps):
        m = v * torch.tensor(f, device=x.device)
        s += (torch.round(m) + 3.0).clamp(-128.0, 127.0).to(torch.int32)
    return s


def probe_requant_chain(x: torch.Tensor, reps: int = 16) -> torch.Tensor:
    """int8 ``x`` -> int32 ``sum_r clip(round(f32(x * 1000) * f32(1e-4 *
    (r + 1))) + 3, -128, 127)``, elementwise (inkernel_probe's ``kreq``)."""
    _tensor(x, "probe_requant_chain", (torch.int8,))
    if reps < 1:
        raise ValueError("probe_requant_chain: reps >= 1")
    if _device(x, "probe_requant_chain") == "cpu":
        return probe_requant_chain_plain(x, reps)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    params = (1, 0, 1, 4, 0, x.numel(), 1, 1, 1, 1, 0, 1, 0, 3, 0, 0, 2, reps)
    _launch("yf_probe_dw", "probe_requant_chain", x.data_ptr(), None, None,
            out.data_ptr(), params, device=x.device)
    probe_requant_chain.launches += 1
    return out


probe_requant_chain.launches = 0


# --------------------------------------------------------------------------
# 1x1 convs
# --------------------------------------------------------------------------
def conv_smem_bytes(variant: str, k: int) -> int:
    """Dynamic shared memory of a tile variant's block at depth ``k``."""
    kp = -(-k // 32) * 32
    elem = 2 if variant == "mma_bf16" else 1
    return 2 * TM * (kp + _SKEW[variant]) * elem + TM * TN * 4


def bf16_exact(k: int, reps: int) -> bool:
    """Whether the bf16 mma's float32 sums stay exact integers (below
    2**24) for any int8 input and int8 weights plus r at depth ``k``."""
    return k * 128 * 128 * reps < 1 << 24


def _conv_args(x, w, variant, epi, reps=1, slabs_per_block=None):
    """Check probe_conv's arguments -> (m, k, nout, ldo, frames)."""
    _tensor(x, "probe_conv x", (torch.int8,))
    _tensor(w, "probe_conv w", (torch.int8,), 2)
    if variant not in CONV_VARIANTS or epi not in CONV_EPIS:
        raise ValueError(f"probe_conv: variant {variant!r}, epi {epi!r}")
    if slabs_per_block is not None and (variant != "mma_rows"
                                        or int(slabs_per_block) < 1):
        raise ValueError(f"probe_conv: slabs_per_block {slabs_per_block} "
                         "(the mma_rows walk: None, or 1 and more)")
    fi = variant in FRAME_INNER
    if x.dim() < (3 if fi else 2):
        raise ValueError(f"probe_conv: x {tuple(x.shape)}")
    nout, k = w.shape
    frames = x.shape[-1] if fi else 1
    if (x.shape[-2] if fi else x.shape[-1]) != k:
        raise ValueError(f"probe_conv: x {tuple(x.shape)} against weights "
                         f"{tuple(w.shape)}")
    if epi == "shift" and nout > k:
        raise ValueError("probe_conv: shift copies channels Nout.. of x: "
                         "Nout <= K")
    if variant == "mma_bf16" and not bf16_exact(k, 1):
        raise ValueError(f"probe_conv: bf16 sums at K = {k} pass 2**24")
    if variant == "fi4" and frames % 4:
        raise ValueError("probe_conv: fi4 takes frames in fours")
    if variant == "fi_mma" and (epi == "raw" or reps != 1 or k > FI_MAX_K
                                or nout > FI_MAX_NOUT):
        raise ValueError(f"probe_conv fi_mma: int8 out (shift or wrap), one "
                         f"repetition, K <= {FI_MAX_K}, Nout <= "
                         f"{FI_MAX_NOUT}; got {epi}, R = {reps}, K = {k}, "
                         f"Nout = {nout}")
    if variant == "mma_rows":
        why = mma_rows_refuses(k, nout) or (
            None if _aligned(x, w) else "x and w must be 16-byte aligned")
        if why:
            raise ValueError(f"probe_conv mma_rows: {why}")
    elif variant not in FRAME_INNER and variant != "loop" and \
            conv_smem_bytes(variant, k) > SMEM_LIMIT:
        raise ValueError(f"probe_conv: K = {k} passes one block's shared "
                         "memory")
    m = x.numel() // (k * frames)
    ldo = k if epi == "shift" else nout
    if m * ldo * frames >= 1 << 31:
        raise ValueError("probe_conv: the output passes int32 indices")
    return m, k, nout, ldo, frames


def mma_rows_refuses(k: int, nout: int) -> Optional[str]:
    """Why ``variant="mma_rows"`` does not take depth ``k`` and ``nout``
    output channels, or None where it does: K from 1 to ``ROWS_MAX_K``,
    Nout from 1 to ``ROWS_MAX_NOUT``."""
    if not 1 <= k <= ROWS_MAX_K:
        return f"K = {k}: 1 to {ROWS_MAX_K}"
    if not 1 <= nout <= ROWS_MAX_NOUT:
        return f"Nout = {nout}: 1 to {ROWS_MAX_NOUT}"
    return None


def mma_rows_shape(k: int, nout: int) -> dict:
    """The mma_rows instantiation that takes ``k`` and ``nout``: ``any``
    (csrc/probe_nhwc_mma_any.cu's kernel: K not a multiple of 4 or Nout
    past ``ROWS_FAST_NOUT``), ``groups`` of ``tiles`` n-tiles of 8 (one
    group of every n-tile otherwise), ``k_chunks`` of 16."""
    nt = -(-nout // 8)
    any_ = bool(k % 4) or nout > ROWS_FAST_NOUT
    groups = -(-nt // ROWS_GROUP) if any_ else 1
    return dict(any=any_, groups=groups, tiles=-(-nt // groups),
                k_chunks=-(-k // 16))


def mma_rows_plan(k: int, nout: int, epi: str, slab: int = ROWS_SLAB
                  ) -> dict:
    """The mma_rows block's shared memory: a ring of ``stages`` slabs of
    ``slab`` rows of input (the most, up to ``ROWS_MAX_STAGES``, that keep
    three blocks an SM, each with the 1 KB the card reserves a block; two
    at least), for ``raw`` and ``wrap`` one output slab buffer, and for
    ``mma_rows_shape``'s ``any`` kernel the B table (128 B a chunk of an
    n-tile), in ``smem`` bytes of dynamic shared memory; ``blocks`` an SM that fit (three, or fewer
    where two stages pass a third of the SM: the wide RAW slab of Nout 144,
    147,456 B, leaves one)."""
    shp = mma_rows_shape(k, nout)
    out = 0 if epi == "shift" else slab * nout * (4 if epi == "raw" else 1)
    table = (shp["groups"] * shp["tiles"] * shp["k_chunks"] * 128
             if shp["any"] else 0)
    for stages in range(ROWS_MAX_STAGES, 1, -1):
        smem = stages * slab * k + out + table
        if smem <= ROWS_BLOCK_SMEM:
            break
    return dict(stages=stages, smem=smem,
                blocks=min(3, SM_SMEM // (smem + 1024)))


def _out_shape(x, variant, ldo):
    if variant in FRAME_INNER:
        return (*x.shape[:-2], ldo, x.shape[-1])
    return (*x.shape[:-1], ldo)


def probe_conv_plain(x, w, *, variant="mma", epi="raw", reps=1,
                     tiles_per_block=None, slabs_per_block=None):
    m, k, nout, ldo, _ = _conv_args(x, w, variant, epi, reps,
                                    slabs_per_block)
    fi = variant in FRAME_INNER
    xs = x.movedim(-1, -2) if fi else x                   # [..., (N,) K]
    wsum = sum((w.to(torch.int32) + r).to(torch.int8).to(torch.float64)
               for r in range(reps))                      # w + r in int8
    acc = (xs.to(torch.float64) @ wsum.T).to(torch.int64).to(torch.int32)
    if epi == "raw":
        out = acc
    elif epi == "wrap":
        out = acc.to(torch.int8)                           # two's complement
    else:
        r = (acc >> 7).clamp(-128, 127).to(torch.int8)
        out = xs.clone()
        out[..., :nout] = r
    return out.movedim(-1, -2).contiguous() if fi else out


def probe_conv(x, w, *, variant="mma", epi="raw", reps=1,
               tiles_per_block: Optional[int] = None,
               slabs_per_block: Optional[int] = None):
    """A 1x1 conv of int8 ``x`` with int8 weights ``w`` [Nout, K], summed
    over ``reps`` repetitions of the weights plus r (wrapped to int8).
    NHWC variants: ``x`` [..., K] (positions by channels); frame-innermost
    ``fi``/``fi4``: ``x`` [..., K, N].  ``epi``: ``raw`` int32 sums [...,
    Nout(, N)]; ``wrap``
    int8(acc); ``shift`` int8 [..., K(, N)] with channels < Nout
    ``clip(acc >> 7)`` and the rest copied from ``x``.  The tile variants
    walk ``tiles_per_block`` 64-row tiles a block (default: about eight
    blocks an SM).  ``fi_mma``: the frame-innermost 1x1 on the int8 tensor
    cores (``shift`` or ``wrap``, one repetition, K <= 64, Nout <= 32; a
    frame count that is not a multiple of 8 takes byte accesses).
    ``mma_rows``: the NHWC 1x1 on the int8 tensor cores in slabs of rows
    (every epilogue and R; K up to 64, Nout up to 144, ``x`` and ``w``
    16-byte aligned: ``mma_rows_refuses``), walked by persistent blocks
    strided over the slabs (``slabs_per_block`` None) or by a block for
    each ``slabs_per_block`` consecutive slabs of ``ROWS_SLAB`` rows (1
    and more; a ragged last block)."""
    m, k, nout, ldo, frames = _conv_args(x, w, variant, epi, reps,
                                         slabs_per_block)
    if _device(x, "probe_conv") == "cpu":
        return probe_conv_plain(x, w, variant=variant, epi=epi, reps=reps)
    if reps < 1 or w.device != x.device or (
            variant == "mma_bf16" and not bf16_exact(k, reps)):
        raise ValueError("probe_conv: reps >= 1 (bf16: sums below 2**24), "
                         "w on x's device")
    out = torch.empty(_out_shape(x, variant, ldo),
                      dtype=torch.int32 if epi == "raw" else torch.int8,
                      device=x.device)
    if out.numel() == 0:
        return out
    if not _aligned(x, w, out):
        raise ValueError("probe_conv: tensors must be 16-byte aligned")
    if variant == "fi_mma":
        _launch("yf_probe_fi_mma", "probe_conv fi_mma", x.data_ptr(),
                w.data_ptr(), out.data_ptr(),
                (m, k, nout, ldo, frames, CONV_EPIS.index(epi),
                 int(frames % 8 == 0)), device=x.device)
        probe_conv.launches += 1
        probe_conv.fi_mma_launches += 1
        return out
    if variant == "mma_rows":
        _launch("yf_probe_nhwc_mma", "probe_conv mma_rows", x.data_ptr(),
                w.data_ptr(), out.data_ptr(),
                (m, k, nout, CONV_EPIS.index(epi), reps,
                 mma_rows_plan(k, nout, epi)["stages"],
                 slabs_per_block or 0), device=x.device)
        probe_conv.launches += 1
        probe_conv.mma_rows_launches += 1
        return out
    if tiles_per_block is None:          # about eight blocks an SM
        blocks = -(-m // TM) * -(-nout // TN)
        tiles_per_block = max(1, -(-blocks // (132 * 8)))
    params = (CONV_VARIANTS.index(variant), CONV_EPIS.index(epi), m, k, nout,
              ldo, frames, reps, tiles_per_block)
    _launch("yf_probe_conv", "probe_conv", x.data_ptr(), w.data_ptr(),
            out.data_ptr(), params, device=x.device)
    probe_conv.launches += 1
    return out


probe_conv.launches = 0
probe_conv.fi_mma_launches = 0
probe_conv.mma_rows_launches = 0


def _kernel_attrs(fn: str, *args) -> dict:
    from yoloface_tpu_torch.kernels._build import PROBES, check, library
    out = (ctypes.c_int * 4)()
    check(getattr(library(PROBES), fn)(*args, out), f"{fn}")
    regs, local, static_smem, blocks = list(out)
    return dict(registers=regs, local_bytes=local, static_smem=static_smem,
                blocks_per_sm=blocks)


def dw_frames_attrs(sp: int, c: int, so: int, stride: int = 1,
                    offs: bool = True, epi: str = "shift") -> dict:
    """The frames kernel's instantiation (stride, offs, epi) as built:
    registers and local bytes a thread (its stack frame, spills included),
    static shared bytes and blocks an SM at the plan's shared memory for
    [N, sp, sp, c] frames; the plan beside them."""
    if epi not in DW_EPIS[:3]:
        raise ValueError(f"probe_dw frames: epi {epi!r}")
    plan = dw_frames_plan(sp, c, so, stride, offs)
    return dict(_kernel_attrs("yf_probe_dw_frames_attrs", stride, int(offs),
                              DW_EPIS.index(epi), plan["smem"]), **plan)


def fi_mma_attrs(nout: int, vec: bool = True) -> dict:
    """The fi_mma instantiation for ``nout`` output channels (n-tiles of
    8) with 8-byte (frame counts a multiple of 8) or byte accesses, as
    built (``dw_frames_attrs``' keys)."""
    if not 1 <= nout <= FI_MAX_NOUT:
        raise ValueError(f"probe_conv fi_mma: Nout {nout}")
    return _kernel_attrs("yf_probe_fi_mma_attrs", -(-nout // 8), int(vec))


def mma_rows_attrs(k: int, nout: int, epi: str = "raw",
                   runs: bool = False) -> dict:
    """The mma_rows instantiation for depth ``k`` and ``nout`` output
    channels (``mma_rows_shape``) in the persistent walk or (``runs``) the
    walk in runs of ``slabs_per_block``, as built, at the shared memory of
    epilogue ``epi``'s plan (``dw_frames_attrs``' keys, the shape and
    ``mma_rows_plan``)."""
    why = mma_rows_refuses(k, nout) or (
        None if epi in CONV_EPIS else f"epi {epi!r}")
    if why:
        raise ValueError(f"probe_conv mma_rows: {why}")
    shp, plan = mma_rows_shape(k, nout), mma_rows_plan(k, nout, epi)
    return dict(_kernel_attrs("yf_probe_nhwc_mma_attrs", shp["tiles"],
                              shp["k_chunks"],
                              int(shp["any"]) | int(runs) << 1,
                              plan["smem"]), **shp, **plan, runs=runs)


def dw_fi_mma_attrs(arith: str = "i16", vec: bool = True) -> dict:
    """The dw fi_mma instantiation for ``arith``'s output (int16 or int32)
    with 8-byte (frame counts a multiple of 8) or byte accesses, as built
    (``dw_frames_attrs``' keys)."""
    if arith not in ("i32", "i16"):
        raise ValueError(f"probe_dw fi_mma: arith {arith!r}")
    return _kernel_attrs("yf_probe_dw_fi_mma_attrs", int(arith == "i16"),
                         int(vec))


WRAPPERS: Sequence = (probe_copy, probe_phase_select, probe_dw,
                      probe_requant_chain, probe_conv)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    probe_dw.frames_launches = 0
    probe_dw.fi_mma_launches = 0
    probe_conv.fi_mma_launches = 0
    probe_conv.mma_rows_launches = 0


def launches() -> int:
    """The probe kernels' launches since the last ``reset_launches``."""
    return sum(fn.launches for fn in WRAPPERS)
