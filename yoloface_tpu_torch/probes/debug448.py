"""Stream-order checks of a copy kernel feeding torch ops on the card
(B9.10-B9.12): the counterparts of ``tools/debug448_fix.py``,
``debug448_rep.py`` and ``debug448_min.py``.

Usage (on the card)::

    python3 -m yoloface_tpu_torch.probes.debug448 fix|rep|min [batch=128]

The JAX tools hunted a TPU miscompile: an XLA consumer of a Pallas output
computing other bits than the same consumer run on the fetched tensor.  On
the card the question is stream order: a kernel launched on PyTorch's
current stream, with no synchronisation, feeding a torch op, must give the
bits of a run that synchronises and round-trips the tensor through the
host.  Each variant prints ``BIT-EXACT`` or raises.

* ``fix``: t73 (the LEAKY output of op 24, [112, 112, 24] at 448) made by
  the section kernel B6 (the 448 plan's section that holds op 24, ending
  there), then in one run, unsynchronised, the 1x1 24 -> 8 of op 29
  (``Int8Engine(g, "fast2")``'s op for t78) fed t73 raw, through int32,
  through the per-frame copy kernel; the channel-contracting dot; the
  channel sum; the transposed tensor ([W, H, C, N]).  Each against the same
  computed afterwards from the fetched t73.  JAX's ``barrier`` form has no
  counterpart (``optimization_barrier`` is XLA's).
* ``rep``: random t73, through the strip-blocked copy (a block a frame x
  14-row strip) or not, then ops 25-29 (the max-pool, PAD, dw + LEAKY and
  the 1x1 of op 29, the stock-torch ``fast2`` ops): t77 and t78 with the
  kernel against without.
* ``min``: the head conv (op 53, t99 -> t100, ``fast2``): A alone; B beside
  an independent per-frame copy, on the same stream and on a second stream
  joined by ``wait_stream``; C fed by the copy kernel through the NHWC ->
  [W, H, C, N] -> NHWC transposes; D the same transposes without it.  B, C,
  D against A.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.kernels import arena, tiled
from yoloface_tpu_torch.kernels import probes as K
from yoloface_tpu_torch.probes import (card, randint, record, same,
                                       time_chain, variant)
from yoloface_tpu_torch.probes.probe448 import graph448
from yoloface_tpu_torch.runtime.engine import Int8Engine

KEEP = 8                       # frames compared (the JAX tool's)
T73, T77, T78, T99, T100 = 73, 77, 78, 99, 100
STRIPS = 8                     # debug448_rep's W strips of 14 of 112


def _report(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape == want.shape and torch.equal(got, want):
        print(f"{name:8s}: BIT-EXACT", flush=True)
        return
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    d = (got.to(torch.int64) - want.to(torch.int64)).abs()
    raise AssertionError(f"{name}: MISMATCH {int((d > 0).sum())}/"
                         f"{got.numel()} max|d|={int(d.max())}")


def _copy_row(x: torch.Tensor, runs: int, **kw) -> Dict:
    """The copy kernel's time on ``x`` beside Tensor.clone's, each a call
    in a chain of 20 (each copying the last one's output); first one call
    and one chain of the kernel are held against Tensor.clone of ``x`` bit
    for bit (raising on a mismatch)."""
    v = x
    for _ in range(20):
        v = K.probe_copy(v, **kw)
    same(K.probe_copy(x, **kw), K.probe_copy_plain(x), f"copy {kw}")
    same(v, K.probe_copy_plain(x), f"a chain of 20 copies {kw}")
    return variant(time_chain(lambda y: K.probe_copy(y, **kw), x, 20, runs),
                   (2 * x.numel(), 0, 0), library="Tensor.clone",
                   library_ms=time_chain(torch.clone, x, 20, runs))


def _record(probe: str, head: str, out: Dict, dev, **extra) -> Dict:
    """The copy's plain version is Tensor.clone, the library call."""
    clone = out[head]["library_ms"]
    return record(probe, head, out, clone, 0.0, dev, library_ms=clone,
                  **extra)


def _op_fn(eng: Int8Engine, out_idx: int):
    return dict(eng._plan)[out_idx]


def t73_section(g: GraphDef) -> tiled.Section:
    """The fast2 strip program that makes t73: the 448 plan's section
    holding op 24, ended there (a one-op section where the plan is the
    whole-frame arena)."""
    lops, alias = arena.lower_arena_ops(g, "fast2")
    j = next(i for i, lp in enumerate(lops) if lp.out == T73)
    start = next((st.start for st in tiled.build_tiled_plan(g)
                  if isinstance(st, tiled.Section) and st.start <= j < st.end),
                 j)
    sec = tiled.plan_section(g, lops, start, j + 1, alias)
    if sec is None or T73 not in sec.outputs:
        raise RuntimeError("no strip program ends at t73")
    return sec


def fix(batch: int = 128, device="cuda", graph: GraphDef = None,
        runs: int = 5) -> Dict:
    """B9.10; -> the per-frame copy's record."""
    dev = card(device)
    g = graph if graph is not None else graph448()
    sec = t73_section(g)
    descs, consts = (torch.from_numpy(a).to(dev)
                     for a in (sec.descs, sec.consts))
    ins = [randint((batch, *sec.shapes[i]), -128, 128, dev, 10 + k)
           for k, i in enumerate(sec.inputs)]
    conv = _op_fn(Int8Engine(g, "fast2", device=dev), T78)
    op29 = g.ops[29]
    w29 = torch.from_numpy(g.tensor(op29.inputs[1]).data.reshape(
        -1, g.tensor(op29.inputs[1]).data.shape[-1]).astype("float64")).to(dev)

    def whcn(t):       # the channel-contracting dot, exact in float64
        return torch.einsum("nhwc,oc->nhwo", t.to(torch.float64),
                            w29).to(torch.int32)

    def csum(t):
        return t.to(torch.int32).sum(-1, dtype=torch.int32)

    def tfetch(t):     # NHWC -> [W, H, C, N]
        return t.permute(2, 1, 3, 0).contiguous()

    # one run on the current stream, no synchronisation
    t73 = tiled.tiled_section(sec, descs, consts, ins)[sec.outputs.index(T73)]
    res = {"raw": conv({T77: t73})[:KEEP],
           "i32": conv({T77: t73.to(torch.int32).to(torch.int8)})[:KEEP],
           "pcopy": conv({T77: K.probe_copy(t73, "frame")})[:KEEP],
           "whcn": whcn(t73)[:KEEP], "csum": csum(t73)[:KEEP],
           "tfetch": tfetch(t73)[..., :KEEP]}
    kept = t73[:KEEP].cpu()                  # the fetched t73
    print("program done", flush=True)
    t = kept.to(dev)
    ref = {"conv": conv({T77: t}), "whcn": whcn(t), "csum": csum(t),
           "tfetch": tfetch(t)}
    print("reference done", flush=True)
    for k, want in (("raw", ref["conv"]), ("i32", ref["conv"]),
                    ("pcopy", ref["conv"]), ("whcn", ref["whcn"]),
                    ("csum", ref["csum"]), ("tfetch", ref["tfetch"])):
        _report(k, res[k], want)
        if k == "raw":
            print(f"{'barrier':8s}: no counterpart: XLA-only", flush=True)
    out = {"frame copy t73": _copy_row(t73, runs, schedule="frame")}
    return _record("debug448 fix", "frame copy t73", out, dev, batch=batch,
                   strips=sec.strips)


def rep(batch: int = 128, device="cuda", graph: GraphDef = None,
        runs: int = 5) -> Dict:
    """B9.11; -> the strip-blocked copy's record."""
    dev = card(device)
    g = graph if graph is not None else graph448()
    eng = Int8Engine(g, "fast2", device=dev)
    outs = {op.outputs[0] for op in g.ops[25:30]}
    chain_ops = [(i, fn) for i, fn in eng._plan if i in outs]
    x = randint((batch, *g.tensor(T73).shape[1:]), -128, 128, dev, 0)

    def chain(x73):
        env = {T73: x73}
        for i, fn in chain_ops:
            env[i] = fn(env)
        return env[T78], env[T77]

    r78, r77 = chain(x)
    print("ref chain done", flush=True)
    p78, p77 = chain(K.probe_copy(x, "strip", strips=STRIPS))
    print("copy-kernel chain done", flush=True)
    for name, a, b in (("t77", p77, r77), ("t78", p78, r78)):
        _report(name, a, b)
    out = {"strip copy t73": _copy_row(x, runs, schedule="strip",
                                       strips=STRIPS)}
    return _record("debug448 rep", "strip copy t73", out, dev, batch=batch)


def min_(batch: int = 128, device="cuda", graph: GraphDef = None,
         runs: int = 5) -> Dict:
    """B9.12; -> the per-frame copy's record."""
    dev = card(device)
    g = graph if graph is not None else graph448()
    conv = _op_fn(Int8Engine(g, "fast2", device=dev), T100)
    x = randint((batch, *g.tensor(T99).shape[1:]), -128, 128, dev, 0)
    to_whcn, to_nhwc = (2, 1, 3, 0), (3, 1, 0, 2)

    def b_same_stream():
        y = conv({T99: x})
        K.probe_copy(x, "frame")
        return y

    def b_second_stream():
        if dev.type != "cuda":
            return b_same_stream()
        main_s = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main_s)
        with torch.cuda.stream(side):
            c = K.probe_copy(x, "frame")
        y = conv({T99: x})
        main_s.wait_stream(side)
        del c
        return y

    def c_through_copy():
        w = K.probe_copy(x.permute(to_whcn).contiguous(), "frame")
        return conv({T99: w.permute(to_nhwc).contiguous()})

    def d_no_copy():
        w = x.permute(to_whcn).contiguous()
        return conv({T99: w.permute(to_nhwc).contiguous()})

    ya = conv({T99: x})
    print("A (conv alone) done", flush=True)
    for name, fn in (("B", b_same_stream), ("B stream2", b_second_stream),
                     ("C", c_through_copy), ("D", d_no_copy)):
        _report(name, fn(), ya)
    out = {"frame copy t99": _copy_row(x, runs, schedule="frame")}
    return _record("debug448 min", "frame copy t99", out, dev, batch=batch)


PROBES = {"fix": fix, "rep": rep, "min": min_}


def main(argv: Sequence[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in PROBES:
        print(f"usage: debug448 {'|'.join(PROBES)} [batch]", file=sys.stderr)
        return 2
    PROBES[argv[0]](int(argv[1]) if len(argv) > 1 else 128)
    return 0


if __name__ == "__main__":
    sys.exit(main())
