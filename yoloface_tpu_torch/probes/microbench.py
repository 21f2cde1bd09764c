"""Microbenchmarks of the ported kernels' building blocks on the card
(B9.1-B9.6): the counterpart of ``tools/microbench.py``.

Usage (on the card)::

    python3 -m yoloface_tpu_torch.probes.microbench conv1x1 [batch] [Ci] [Co] [S]
    python3 -m yoloface_tpu_torch.probes.microbench whcn [batch] [Ci] [Co] [S]
    python3 -m yoloface_tpu_torch.probes.microbench inkernel [batch]
    python3 -m yoloface_tpu_torch.probes.microbench dw16 [batch]
    python3 -m yoloface_tpu_torch.probes.microbench packdot [batch]
    python3 -m yoloface_tpu_torch.probes.microbench rows_sweep [batch]
    python3 -m yoloface_tpu_torch.probes.microbench [batch] [C] [S]

with the JAX tool's defaults.  The layouts are the port's: NHWC ([N, S, S,
C], positions by channels) where the JAX tool kept [C, S, S, N], and the
frame-innermost [S, S, C, N] where it kept that.  Inputs are made on the
device from fixed seeds.  Every variant's output on the timed input is
first held against its plain version on the same input, bit for bit.
``conv1x1``, ``whcn`` and the dw-shaped ``main`` time chains of 20 calls
(each fed the last output); ``conv1x1``, ``whcn``, ``inkernel``,
``dw16``, ``packdot`` and ``main`` time each kernel that PR 7 ported and
a later one redesigned beside its redesign (``... (PR 7)``, the redesign
the headline) and print the redesign's registers and local bytes;
``inkernel``, ``dw16`` and ``packdot`` repeat the op R = 16 times inside
one launch and report the time an op.  ``rows_sweep`` builds the NHWC
1x1's Hopper form with other block shapes and times them at the
``conv1x1`` and ``inkernel`` shapes.
``section_1x1`` times the tiled section kernel B6 on a net's 1x1 conv, the
body the ``conv1x1`` loop restates.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import arena, tiled
from yoloface_tpu_torch.kernels import probes as K
from yoloface_tpu_torch.probes import (HBM_RATE, card, device_name, randint,
                                       record, same, show, show_attrs,
                                       time_chain, time_ms, variant)

R = 16                     # repetitions inside a launch
NT = 128                   # the JAX tools' frame tile: the unit of ns/dot
QM, SHIFT = 1518500250, -7          # main's exact requant
# conv1x1's records: key -> (probe_conv variant, label); "mma" is the
# NHWC 1x1's Hopper form (csrc/probe_nhwc_mma.cu) where it takes the shape,
# else probe_conv.cu's tile kernel
CONV1X1 = {"loop": ("loop", "conv_op loop"), "dp4a": ("dp4a", "dp4a smem"),
           "mma": ("mma_rows", "mma s8"),
           "mma (PR 7)": ("mma", "mma s8 (PR 7)")}
# inkernel's NHWC variants: variant -> label (the tile kernel's mma with
# " (PR 7)" after the shape)
INKERNEL = {"loop": "loop", "imad": "imad smem", "dp4a": "dp4a smem",
            "mma_rows": "mma s8", "mma": "mma s8", "mma_bf16": "mma bf16"}


def conv1x1_probe(batch: int = 32768, ci: int = 36, co: int = 24,
                  s: int = 14, device="cuda", reps: int = 20,
                  runs: int = 3) -> Dict:
    """B9.1: the 1x1 conv with ``clip(acc >> 7)`` on the first ``co``
    channels and the rest copied, as the arena's CUDA-core loop, __dp4a
    from shared memory and int8 mma: the headline ``mma`` the Hopper form
    (``variant="mma_rows"``, row slabs streamed through shared memory),
    ``mma (PR 7)`` the tile kernel it replaced, K zero-padded to 32.  Where
    the Hopper form does not take the shape (``K.mma_rows_refuses``: K a
    multiple of 4 up to 64, Nout up to 64), the record says so in
    ``left_out`` and ``mma`` is the tile kernel."""
    dev = card(device)
    w = randint((co, ci), -64, 64, dev, 1)
    x = randint((batch, s, s, ci), -128, 128, dev, 0)
    why = K.mma_rows_refuses(ci, co)
    cases = ({"loop": CONV1X1["loop"], "dp4a": CONV1X1["dp4a"],
              "mma": ("mma", "mma s8")} if why else CONV1X1)

    def plain():
        return K.probe_conv_plain(x, w, variant="mma", epi="shift")

    want = plain()
    err = max(same(K.probe_conv(x, w, variant=v, epi="shift"), want,
                   f"conv1x1 {key}") for key, (v, _) in cases.items())
    del want
    gmac = ci * co * s * s * batch / 1e9
    work = (2 * x.numel() + w.numel(), gmac * 1e9, 0)
    print(f"1x1 probe Ci={ci} Co={co} S={s} batch={batch} ({gmac:.1f} "
          f"GMAC/op; {device_name(dev)})", flush=True)
    extra = dict(kernels={key: v for key, (v, _) in cases.items()})
    if why:
        extra["left_out"] = {"mma_rows": why}
        print(f"{'':>4s}mma_rows left out: {why}", flush=True)
    else:
        extra.update(replaced="mma (PR 7)", attrs={})
        if dev.type == "cuda":
            extra["attrs"]["mma"] = K.mma_rows_attrs(ci, co, "shift")
            show_attrs("mma s8", extra["attrs"]["mma"])
    out = {}
    for key, (v, label) in cases.items():
        ms = time_chain(lambda y, v=v: K.probe_conv(y, w, variant=v,
                                                    epi="shift"),
                        x, reps, runs)
        out[key] = variant(ms, work)
        show(label, out[key], 22, gmac=gmac)
    return record("conv1x1", "mma", out, time_ms(plain, dev, runs), err,
                  dev, batch=batch, shape=[ci, co, s], **extra)


def section_1x1(graph: GraphDef, batch: int = 256, ci: int = 1024,
                co: int = 256, s: int = 13, device="cuda",
                runs: int = 3) -> Dict:
    """The tiled section kernel B6 (``csrc/tiled_section.cu``, the
    ``conv_op`` body of ``csrc/arena_ops.cuh`` on strips in shared memory)
    on a one-op strip section of ``graph``'s first 1x1 conv of ``ci`` ->
    ``co`` channels at ``s`` x ``s`` (its fused LEAKY included), in fast2
    bits (``tiled2``'s); held against the section's plain version on the
    timed input.
    -> the record of the section (``ms``, ``gmac_per_ms``, ``strips``)."""
    dev = card(device)
    lops, alias = arena.lower_arena_ops(graph, "fast2")
    j = next((k for k, lp in enumerate(lops)
              if lp.code == arena.CONV and lp.window[:2] == (1, 1)
              and arena._hwc(graph, lp.ins[0]) == (s, s, ci)
              and arena._hwc(graph, lp.out)[2] == co), None)
    if j is None:
        raise ValueError(f"{graph.name}: no 1x1 conv {ci} -> {co} at {s}x{s}")
    sec = tiled.plan_section(graph, lops, j, j + 1, alias)
    if sec is None or len(sec.inputs) != 1:
        raise RuntimeError(f"the 1x1 conv of lowered op {j} fits no strip "
                           "program of one input")
    descs, consts = (torch.from_numpy(a).to(dev)
                     for a in (sec.descs, sec.consts))
    x = randint((batch, *sec.shapes[sec.inputs[0]]), -128, 128, dev, 0)
    outs = [torch.empty((batch, *sec.shapes[o]), dtype=torch.int8,
                        device=dev) for o in sec.outputs]

    def kernel():
        return tiled.tiled_section(sec, descs, consts, [x])

    def plain():
        tiled.tiled_section_plain(sec, consts, [x] + outs)

    plain()
    err = max(same(got, want, f"B6 1x1 {ci}->{co}@{s}")
              for got, want in zip(kernel(), outs))
    gmac = ci * co * s * s * batch / 1e9
    rec = variant(time_ms(kernel, dev, runs),
                  (x.numel() + sum(t.numel() for t in outs), gmac * 1e9, 0),
                  strips=sec.strips, lowered_op=j)
    rec["gmac_per_ms"] = gmac / rec["ms"]
    show(f"B6 section 1x1 {ci}x{co}@{s}", rec, 30, gmac=gmac)
    return dict(rec, plain_ms=time_ms(plain, dev, min(runs, 2)),
                max_abs_err=err, batch=batch, shape=[ci, co, s],
                device=device_name(dev))


def whcn_probe(batch: int = 32768, ci: int = 36, co: int = 24, s: int = 14,
               device="cuda", reps: int = 20, runs: int = 3) -> Dict:
    """B9.2: the frame-innermost [S, S, C, N] layout: the 1x1 on the int8
    tensor cores (``fi_mma``, the headline), as PR 7's one thread a frame
    and four frames a thread (char4), and the depthwise taps at stride 1
    and 2 (the borders copied)."""
    dev = card(device)
    w = randint((co, ci), -64, 64, dev, 1)
    taps = randint((9, ci), -128, 128, dev, 3, torch.int32)
    conv, dw = (K.probe_conv, K.probe_conv_plain), (K.probe_dw,
                                                     K.probe_dw_plain)
    mm = ci * co * s * s * batch / 1e9
    cases = {   # name: ((kernel, plain), weights, kwargs, GMAC)
        "fi i8 mma": (conv, w, dict(variant="fi_mma", epi="shift"), mm),
        "fi i8 char4 (PR 7)": (conv, w, dict(variant="fi4", epi="shift"),
                               mm),
        "fi i8 loop": (conv, w, dict(variant="fi", epi="shift"), mm),
        "dw taps fi offs": (dw, taps, dict(so=s - 2, layout="fi", origin=1),
                            ci * (s - 2) ** 2 * batch * 9 / 1e9),
        "dw taps fi stride2 i8": (
            dw, taps, dict(so=(s - 2) // 2, layout="fi", origin=1, stride=2),
            ci * ((s - 2) // 2) ** 2 * batch * 9 / 1e9),
    }
    x = randint((s, s, ci, batch), -128, 128, dev, 0)
    err = max(same(kern(x, t, **kw), plain(x, t, **kw), f"whcn {k}")
              for k, ((kern, plain), t, kw, _) in cases.items())
    print(f"whcn probe Ci={ci} Co={co} S={s} batch={batch} "
          f"({device_name(dev)})", flush=True)
    attrs = {}
    if dev.type == "cuda":
        attrs["fi i8 mma"] = K.fi_mma_attrs(co, vec=batch % 8 == 0)
        show_attrs("fi i8 mma", attrs["fi i8 mma"])
    out = {}
    for k, ((kern, _), t, kw, gmac) in cases.items():
        ms = time_chain(lambda y, t=t, kw=kw: kern(y, t, **kw), x, reps, runs)
        out[k] = variant(ms, (2 * x.numel(), gmac * 1e9, 0))
        show(k, out[k], 26, gmac=gmac)
    plain = time_ms(lambda: K.probe_conv_plain(x, w, variant="fi4",
                                               epi="shift"), dev, runs)
    return record("whcn", "fi i8 mma", out, plain, err, dev, batch=batch,
                  shape=[ci, co, s], replaced="fi i8 char4 (PR 7)",
                  attrs=attrs)


def inkernel_probe(batch: int = 32768, device="cuda", runs: int = 3) -> Dict:
    """B9.3: each op R times inside one launch on data already on chip, the
    weights plus r: the 1x1 in NHWC (the CUDA-core loop, byte
    multiply-adds and __dp4a from shared memory, int8 mma in the Hopper
    form, ``mma_rows``, the headline, and as the tile kernel, ``...
    (PR 7)``, and bf16 mma) and frame innermost, the depthwise taps, the
    fast requant chain.  Int32 sums out."""
    dev = card(device)
    out, err = {}, 0.0
    plain_ms = None
    attrs = {}
    print(f"inkernel probe R={R} batch={batch} ({device_name(dev)})",
          flush=True)

    def run(name, call, want, work, gmac):
        nonlocal err
        err = max(err, same(call(), want, f"inkernel {name}"))
        out[name] = variant(time_ms(call, dev, runs), work)
        show(name, out[name], 34, per=R, gmac=gmac)

    head = "nhwc 1x1 mma s8 36x36@14"
    for ci, co, s in ((36, 36, 14), (40, 40, 7)):
        w = randint((co, ci), -64, 64, dev, 1)
        macs = ci * co * s * s * batch * R
        for layout in ("nhwc", "fi"):
            shape = ((batch, s, s, ci) if layout == "nhwc"
                     else (s, s, ci, batch))
            x = randint(shape, -128, 128, dev, 0)
            work = (x.numel() + 4 * batch * s * s * co + w.numel(), macs, 0)
            names = INKERNEL if layout == "nhwc" else {"fi": "fi loop",
                                                       "fi4": "fi char4"}
            first = next(iter(names))

            def plain(x=x, w=w, v=first):
                return K.probe_conv_plain(x, w, variant=v, epi="raw", reps=R)

            want = plain()
            if layout == "nhwc" and dev.type == "cuda":
                name = f"nhwc 1x1 {INKERNEL['mma_rows']} {ci}x{co}@{s}"
                attrs[name] = K.mma_rows_attrs(ci, co, "raw")
                show_attrs(name, attrs[name])
            for v, label in names.items():
                name = f"{layout} 1x1 {label} {ci}x{co}@{s}" + (
                    " (PR 7)" if layout == "nhwc" and v == "mma" else "")
                run(name, lambda x=x, w=w, v=v: K.probe_conv(
                    x, w, variant=v, epi="raw", reps=R), want, work,
                    macs / 1e9)
                if name == head:
                    plain_ms = time_ms(plain, dev, runs)
            del x, want
    c, s = 8, 28
    taps = randint((9, c), -128, 128, dev, 3, torch.int32)
    x = randint((batch, s + 2, s + 2, c), -128, 128, dev, 0)
    kw = dict(so=s, border="zero", epi="raw", reps=R)
    run(f"nhwc dw taps C={c}@{s}", lambda: K.probe_dw(x, taps, **kw),
        K.probe_dw_plain(x, taps, **kw), (5 * x.numel(), c * s * s * batch *
                                          9 * R, 0),
        c * s * s * batch * 9 * R / 1e9)
    # the chain's operations: a multiply, a round, an add, two clamps and
    # the sum, an element a repetition; its "GMAC" counts elements, as the
    # JAX tool's line does
    run(f"nhwc fastrequant C={c}@{s}", lambda: K.probe_requant_chain(x, R),
        K.probe_requant_chain_plain(x, R), (5 * x.numel(), 0,
                                            6 * x.numel() * R),
        x.numel() * R / 1e9)
    return record("inkernel", head, out, plain_ms, err, dev, batch=batch,
                  reps=R, replaced=f"{head} (PR 7)", attrs=attrs)


def dw16_probe(batch: int = 32768, device="cuda", runs: int = 3) -> Dict:
    """B9.4: the depthwise taps R times in the frame-innermost layout, int32
    sums and the sums wrapped to int16, taps in [-8, 8): each variant on
    the int8 tensor cores (``form="fi_mma"``, the headline ``whcn dw i16
    taps C=40@14``) and as PR 7's one thread an output (``... (PR 7)``:
    int32 arithmetic, or __dp2a on 16-bit operands for int16)."""
    dev = card(device)
    out, err = {}, 0.0
    plain_ms = None
    head = "whcn dw i16 taps C=40@14"
    kernels, attrs = {}, {}
    print(f"dw16 probe R={R} batch={batch} ({device_name(dev)})", flush=True)
    for c, s in ((40, 14), (16, 28), (48, 7)):
        sp = s + 2
        taps = randint((9, c), -8, 8, dev, 1, torch.int32)
        x = randint((sp, sp, c, batch), -128, 128, dev, 0)
        macs = c * s * s * batch * 9 * R
        for arith, size in (("i32", 4), ("i16", 2)):
            kw = dict(so=s, layout="fi", border="none", epi="raw", reps=R,
                      arith=arith)
            name = f"whcn dw {arith} taps C={c}@{s}"
            want = K.probe_dw_plain(x, taps, **kw)
            for form, key in (("fi_mma", name), ("thread", f"{name} (PR 7)")):
                err = max(err, same(K.probe_dw(x, taps, form=form, **kw),
                                    want, f"dw16 {key}"))
                kernels[key] = form
            del want
            if dev.type == "cuda":
                attrs[name] = K.dw_fi_mma_attrs(arith, vec=batch % 8 == 0)
                show_attrs(name, attrs[name])
            for key in (name, f"{name} (PR 7)"):
                out[key] = variant(
                    time_ms(lambda key=key: K.probe_dw(
                        x, taps, form=kernels[key], **kw), dev, runs),
                    (x.numel() + size * s * s * c * batch, macs, 0))
                show(key, out[key], 36, per=R, gmac=macs / 1e9)
            if name == head:
                plain_ms = time_ms(lambda: K.probe_dw_plain(x, taps, **kw),
                                   dev, runs)
        del x
    return record("dw16", head, out, plain_ms, err, dev, batch=batch, reps=R,
                  kernels=kernels, replaced=f"{head} (PR 7)", attrs=attrs)


PACK_SHAPES = ((8, 4, 28), (4, 18, 28), (18, 6, 28), (6, 36, 28),
               (36, 24, 28), (40, 8, 28))


def pack_factors(ci: int, co: int, s: int) -> List[int]:
    """The P JAX packs (P*Ci and P*Co at most 128, S a multiple of P) that
    one k-step of the int8 mma holds (P*Ci <= 32)."""
    return [p for p in (2, 4, 8, 16)
            if p * ci <= 128 and p * co <= 128 and s % p == 0
            and p * ci <= 32]


def block_diagonal(w: torch.Tensor, p: int) -> torch.Tensor:
    """[Co, Ci] -> [P*Co, P*Ci] with w on the diagonal blocks."""
    co, ci = w.shape
    wp = torch.zeros((p * co, p * ci), dtype=w.dtype, device=w.device)
    for i in range(p):
        wp[i * co:(i + 1) * co, i * ci:(i + 1) * ci] = w
    return wp


def packed(x: torch.Tensor, wp: torch.Tensor, p: int, reps: int,
           plain: bool = False, variant: str = "mma_rows") -> torch.Tensor:
    """The 1x1 of ``x`` [N, S, S, Ci] with P consecutive positions of the
    last spatial axis packed into one row: [N, S, S/P, P*Ci] @ wp.T, on
    probe_conv's ``variant``."""
    n, s, _, ci = x.shape
    fn = K.probe_conv_plain if plain else K.probe_conv
    y = fn(x.view(n, s, s // p, p * ci), wp, variant=variant, epi="raw",
           reps=reps)
    return y.view(n, s, s, wp.shape[0] // p)


def packdot_probe(batch: int = 8192, device="cuda", runs: int = 3) -> Dict:
    """B9.5: a 1x1 with one position a row against P positions packed
    block-diagonally into one row, R times, int32 out; each variant on the
    NHWC 1x1's Hopper form (``variant="mma_rows"``, the headline ``pack
    P=4 8x4@28``) and as PR 7's tile kernel (``... (PR 7)``, K zero-padded
    to 32); the two layouts are equal at one repetition, on the Hopper
    form.  (The packed weights' zero blocks become r in the R-times form,
    so only the one-repetition form compares the two.)"""
    dev = card(device)
    out, err = {}, 0.0
    plain_ms = None
    head = "pack P=4 8x4@28"
    kernels, attrs = {}, {}
    print(f"packdot probe R={R} batch={batch} ({device_name(dev)})",
          flush=True)
    for ci, co, s in PACK_SHAPES:
        w = randint((co, ci), -64, 64, dev, 1)
        x = randint((batch, s, s, ci), -128, 128, dev, 0)
        macs = ci * co * s * s * batch * R
        work = (x.numel() + 4 * batch * s * s * co + w.numel(), macs, 0)
        dots = s * s * batch / NT
        cases = {f"perpos {ci}x{co}@{s}": (1, w)}   # name: (P, weights)
        for p in pack_factors(ci, co, s):
            cases[f"pack P={p} {ci}x{co}@{s}"] = (p, block_diagonal(w, p))
        for name, (p, wp) in cases.items():
            def call(v, plain=False, p=p, wp=wp):
                return packed(x, wp, p, R, plain=plain, variant=v)

            want = call("mma", plain=True)
            for v, key in (("mma_rows", name), ("mma", f"{name} (PR 7)")):
                err = max(err, same(call(v), want, f"packdot {key}"))
                kernels[key] = v
            del want
            if dev.type == "cuda":
                attrs[name] = K.mma_rows_attrs(p * ci, p * co, "raw")
                show_attrs(name, attrs[name])
            for key in (name, f"{name} (PR 7)"):
                out[key] = variant(time_ms(lambda key=key: call(kernels[key]),
                                           dev, runs), work)
                show(key, out[key], 36, per=R, gmac=macs / 1e9,
                     extra=f", {out[key]['ms'] / R / (dots / p) * 1e6:6.1f} "
                           "ns/dot")
            if name == head:
                plain_ms = time_ms(lambda: call("mma", plain=True), dev,
                                   runs)
        if pack_factors(ci, co, s):     # one repetition: packed == per pos
            p = max(pack_factors(ci, co, s))
            eq = torch.equal(K.probe_conv(x, w, variant="mma_rows",
                                          epi="raw"),
                             packed(x, block_diagonal(w, p), p, 1))
            print(f"{'':>36s}  bit-equal P={p}: {eq}", flush=True)
            if not eq:
                raise AssertionError(f"packdot {ci}x{co}: P={p} packed "
                                     "differs from one position a row")
        del x
    return record("packdot", head, out, plain_ms, err, dev, batch=batch,
                  reps=R, kernels=kernels, replaced=f"{head} (PR 7)",
                  attrs=attrs)


def dw_main(batch: int = 32768, c: int = 8, s: int = 28, device="cuda",
            reps: int = 20, runs: int = 3) -> Dict:
    """B9.6: the dw-shaped kernel on [N, S+2, S+2, C]: the int8 tile copy
    (the floor), the taps without and with offsets and >> 7, fast and exact
    requant and stride 2 on int8 frames, each a block a group of whole
    frames (``form="frames"``, the headline ``taps offs i8 shift``) and as
    PR 7's one thread an output (``... (PR 7)``), and an int32 arena with
    >> 7, stride 2 and fast requant (PR 7's kernel); the computed S x S
    (S/2 at stride 2) corner written over a copy of the input."""
    dev = card(device)
    sp = s + 2
    taps = randint((9, c), -128, 128, dev, 3, torch.int32)
    gen = torch.Generator(device="cpu").manual_seed(4)
    scale = (torch.rand(c, generator=gen, dtype=torch.float64) * 0.01
             + 0.001).to(torch.float32).to(dev)
    int8_cases = {   # name: kwargs of probe_dw
        "taps noffs i8 shift": dict(offs=False),
        "taps offs i8 shift": {},
        "taps offs i8 fastreq": dict(epi="fast", scale=scale),
        "taps offs i8 exactreq": dict(epi="exact", qm=QM, shift=SHIFT),
        "taps offs i8 stride2": dict(stride=2),
    }
    cases = {}      # name: (kwargs of probe_dw, int32 arena)
    for name, args in int8_cases.items():
        cases[name] = (dict(args, form="frames"), False)
        cases[f"{name} (PR 7)"] = (args, False)
    cases.update({
        "taps offs i32-arena shift": ({}, True),
        "taps offs i32-arena stride2": (dict(stride=2), True),
        "taps offs i32-arena fastreq": (dict(epi="fast", scale=scale), True),
    })

    def kw(name):
        args, _ = cases[name]
        return dict(so=s // args.get("stride", 1), **args)

    x8 = randint((batch, sp, sp, c), -128, 128, dev, 0)
    x32 = x8.to(torch.int32)
    err = same(K.probe_copy(x8), K.probe_copy_plain(x8), "int8 tile copy")
    for name, (_, wide) in cases.items():
        y = x32 if wide else x8
        err = max(err, same(K.probe_dw(y, taps, **kw(name)),
                            K.probe_dw_plain(y, taps, **kw(name)), name))
    print(f"dw-shaped microbench C={c} S={s} batch={batch} "
          f"({device_name(dev)})", flush=True)
    attrs = {}
    if dev.type == "cuda":
        for name in int8_cases:
            a = kw(name)
            attrs[name] = K.dw_frames_attrs(
                sp, c, a["so"], a.get("stride", 1), a.get("offs", True),
                a.get("epi", "shift"))
            show_attrs(name, attrs[name])
    out = {}
    ms = time_chain(K.probe_copy, x8, reps, runs)
    out["int8 tile copy"] = variant(
        ms, (2 * x8.numel(), 0, 0),
        library="Tensor.clone",
        library_ms=time_chain(torch.clone, x8, reps, runs),
        hbm_share=2 * x8.numel() / (ms * 1e-3) / HBM_RATE)
    show("int8 tile copy", out["int8 tile copy"], 30,
         extra=f", {out['int8 tile copy']['hbm_share']:.3f} of 3.35 TB/s")
    for name, (_, wide) in cases.items():
        y = x32 if wide else x8
        so = kw(name)["so"]
        gmac = c * so * so * batch * 9 / 1e9
        ms = time_chain(lambda v, name=name: K.probe_dw(v, taps, **kw(name)),
                        y, reps, runs)
        out[name] = variant(ms, (2 * y.numel() * y.element_size(), gmac * 1e9,
                                 0))
        show(name, out[name], 34, gmac=gmac)
    plain = time_ms(lambda: K.probe_dw_plain(x8, taps,
                                             **kw("taps offs i8 shift")),
                    dev, runs)
    return record("dw_main", "taps offs i8 shift", out, plain, err, dev,
                  batch=batch, shape=[c, s],
                  replaced="taps offs i8 shift (PR 7)", attrs=attrs)


# rows_sweep's block shapes of csrc/probe_nhwc_mma.cu: (threads a block,
# 16-row m-tiles a warp); the source's own first
ROWS_SHAPES = ((128, 4), (256, 2), (128, 2), (64, 4))


def _rows_builds(shapes) -> Dict:
    """csrc/probe_nhwc_mma*.cu (the row kernel's four sources: both
    kernels, both walks) built once a block shape (set in their header,
    nhwc_mma.cuh), each set into a library of its own beside the package's
    (one nvcc each, all at once) -> {shape: (library, rows a slab)}."""
    from yoloface_tpu_torch.kernels import _build
    head = (_build.CSRC / "nhwc_mma.cuh").read_text()
    own = ("constexpr int kThreads = 128;", "constexpr int kMTiles = 4;")
    if not all(a in head for a in own):
        raise RuntimeError("nhwc_mma.cuh: the block shape moved")
    cus = sorted(p.name for p in _build.CSRC.glob("probe_nhwc_mma*.cu"))
    kernels = sorted(p.name for p in _build.CSRC.glob("nhwc_mma_*.cuh"))
    jobs = {}
    for threads, mt in shapes:
        out = _build.BUILD_DIR / "rows_sweep" / f"t{threads}_m{mt}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "nhwc_mma.cuh").write_text(
            head.replace(own[0], f"constexpr int kThreads = {threads};")
            .replace(own[1], f"constexpr int kMTiles = {mt};"))
        for src in cus + kernels:   # quoted includes find the headers beside
            (out / src).write_text((_build.CSRC / src).read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(out / "probe_nhwc_mma.so"), *(str(out / cu) for cu in cus)]
        jobs[(threads, mt)] = (cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for shape, (cmd, proc) in jobs.items():
        _build._finish(cmd, *proc.communicate(), proc.returncode)
        lib = ctypes.CDLL(cmd[cmd.index("-o") + 1])
        for fn in ("yf_probe_nhwc_mma", "yf_probe_nhwc_mma_attrs"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        libs[shape] = (lib, 16 * shape[1] * shape[0] // 32)
    return libs


def rows_call(lib, slab: int, x: torch.Tensor, w: torch.Tensor, epi: str,
              reps: int, slabs_per_block: int = 0,
              stages: Optional[int] = None) -> torch.Tensor:
    """probe_conv(x, w, variant="mma_rows", ...) on a library of
    ``_rows_builds`` (slabs of ``slab`` rows): the walk of
    ``slabs_per_block`` (0: persistent), a ring of ``stages`` (default:
    ``K.mma_rows_plan``'s for that slab)."""
    from yoloface_tpu_torch.kernels._build import check
    k, nout = x.shape[-1], w.shape[0]
    out = torch.empty((*x.shape[:-1], k if epi == "shift" else nout),
                      dtype=torch.int32 if epi == "raw" else torch.int8,
                      device=x.device)
    if stages is None:
        stages = K.mma_rows_plan(k, nout, epi, slab)["stages"]
    params = (ctypes.c_int * 7)(x.numel() // k, k, nout,
                                K.CONV_EPIS.index(epi), reps, stages,
                                slabs_per_block)
    check(lib.yf_probe_nhwc_mma(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                params,
                                torch.cuda.current_stream(
                                    x.device).cuda_stream),
          f"rows_call slab {slab}")
    return out


def rows_sweep(batch: int = 32768, device="cuda", runs: int = 3,
               rounds: int = 2) -> Dict:
    """The NHWC 1x1's Hopper form (``variant="mma_rows"``) at other block
    shapes (``ROWS_SHAPES``: threads a block, m-tiles a warp), each built
    from the package's source with those two constants changed: B9.1's
    shift (a call in a chain of 20) and B9.3's raw R = 16 sums at 36x36@14
    and 40x40@7, each held against the plain version on the timed input
    first; the shapes in turn, ``rounds`` times.  On the card only."""
    from yoloface_tpu_torch.kernels._build import check
    dev = card(device)
    if dev.type != "cuda":
        raise RuntimeError("rows_sweep builds kernels: it runs on a CUDA "
                           "card")
    libs = _rows_builds(ROWS_SHAPES)
    print(f"rows_sweep batch={batch} ({device_name(dev)})", flush=True)

    def call(shape, x, w, epi, reps):
        return rows_call(*libs[shape], x, w, epi, reps)

    cases = {}   # name: (x, w, epi, reps, chained)
    x = randint((batch, 14, 14, 36), -128, 128, dev, 0)
    cases["B9.1 shift 36x24@14"] = (x, randint((24, 36), -64, 64, dev, 1),
                                    "shift", 1, True)
    cases["B9.3 raw 36x36@14"] = (x, randint((36, 36), -64, 64, dev, 1),
                                  "raw", R, False)
    cases["B9.3 raw 40x40@7"] = (randint((batch, 7, 7, 40), -128, 128, dev,
                                         0),
                                 randint((40, 40), -64, 64, dev, 1), "raw",
                                 R, False)
    for name, (x, w, epi, reps, _) in cases.items():
        want = K.probe_conv_plain(x, w, variant="mma_rows", epi=epi,
                                  reps=reps)
        for shape in libs:
            same(call(shape, x, w, epi, reps), want, f"rows_sweep {shape} "
                 f"{name}")
        del want
    res = {}
    for (t, m), (lib, _) in libs.items():
        regs = {}
        for probe, nt in (("B9.1", 3), ("B9.3", 5)):   # K 36, 40: 3 chunks
            a = (ctypes.c_int * 4)()
            check(lib.yf_probe_nhwc_mma_attrs(nt, 3, 0, 0, a), "rows_sweep")
            regs[probe] = a[0]
        res[f"{t} threads, {m} m-tiles"] = {"registers": regs}
        print(f"{'':>4s}[attrs] {t} threads, {m} m-tiles: {regs['B9.1']} "
              f"registers a thread (B9.1's instantiation), {regs['B9.3']} "
              "(B9.3's)", flush=True)
    for rnd in range(rounds):
        for (t, m) in libs:
            line = res[f"{t} threads, {m} m-tiles"]
            for name, (x, w, epi, reps, chained) in cases.items():
                fn = (lambda y, s=(t, m), w=w, e=epi, r=reps: call(s, y, w, e,
                                                                   r))
                ms = (time_chain(fn, x, 20, runs) if chained
                      else time_ms(lambda: fn(x), dev, runs))
                line.setdefault(name, []).append(ms)
            print(f"round {rnd} {t:3d} threads, {m} m-tiles: " + ", ".join(
                f"{n} {line[n][-1]:.4f}" for n in cases) + " ms", flush=True)
    return dict(probe="rows_sweep", batch=batch, device=device_name(dev),
                shapes=res)


def _ints(argv: Sequence[str], defaults: Sequence[int]) -> List[int]:
    return [int(a) for a in argv] + list(defaults[len(argv):])


def main(argv: Sequence[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    probes = {"conv1x1": (conv1x1_probe, (32768, 36, 24, 14)),
              "whcn": (whcn_probe, (32768, 36, 24, 14)),
              "inkernel": (inkernel_probe, (32768,)),
              "dw16": (dw16_probe, (32768,)),
              "packdot": (packdot_probe, (8192,)),
              "rows_sweep": (rows_sweep, (32768,))}
    if argv and argv[0] in probes:
        fn, defaults = probes[argv[0]]
        fn(*_ints(argv[1:], defaults))
    else:
        dw_main(*_ints(argv, (32768, 8, 28)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
