"""Ops 0-7 of the 448 net as one strip section on the card (B9.9): the
counterpart of ``tools/probe448.py``.

Usage (on the card)::

    python3 -m yoloface_tpu_torch.probes.probe448 [batch=256]

Ops 0-7 of ``retarget_spatial(corpus, 8)`` -- PAD, the 3x3 s2 stem
(448 -> 224), LEAKY, the dw 3x3, LEAKY, the 1x1 8 -> 4, the 1x1 4 -> 18,
LEAKY -- lowered in fast bits (``arena.lower_arena_ops(g, "fast")``: the
PAD absorbed, each conv fused with its LEAKY) and planned as one strip
program (``tiled.plan_section``) run by the section kernel B6.  Timed against
the port's stock-torch twin on the same subgraph, ``Int8Engine(g, "fast")
._plan[:8]``, with the frames on the card; the section's output must equal
the twin's bit for bit (else this raises after printing).  One JSON line:
the JAX line's fields, ``tiled_section_ms`` for ``pallas_tiled_ms`` and
``twin_fast_ms`` for ``xla_fast_ms``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Sequence

import torch

from yoloface_tpu_torch.graph.ir import GraphDef
from yoloface_tpu_torch.graph.retarget import retarget_spatial
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels import arena, tiled
from yoloface_tpu_torch.probes import card, device_name, randint, time_ms
from yoloface_tpu_torch.runtime.engine import Int8Engine

CORPUS = (Path(__file__).resolve().parents[2] / "checkpoints"
          / "yoloface_corpus_int8.tflite")
OPS = 8                               # graph ops 0-7


def graph448() -> GraphDef:
    return retarget_spatial(load_tflite(str(CORPUS)), 8)


def ops07_section(g: GraphDef, bits: str = "fast") -> tiled.Section:
    """The lowered ops covering graph ops 0-7 as one strip program."""
    lops, alias = arena.lower_arena_ops(g, bits)
    last = g.ops[OPS - 1].outputs[0]
    k = next(i for i, lp in enumerate(lops) if lp.out == last) + 1
    sec = tiled.plan_section(g, lops, 0, k, alias)
    if sec is None:
        raise RuntimeError("ops 0-7 fit no strip program")
    return sec


def stage(batch: int = 256, device="cuda", graph: GraphDef = None,
          runs: int = 3) -> Dict:
    """B6 on ops 0-7 against the stock-torch fast twin; -> the JSON line's
    fields and the times of the section's plain version."""
    dev = card(device)
    g = graph if graph is not None else graph448()
    sec = ops07_section(g)
    last = g.ops[OPS - 1].outputs[0]
    descs, consts = (torch.from_numpy(a).to(dev)
                     for a in (sec.descs, sec.consts))
    twin_plan = Int8Engine(g, "fast", device=dev)._plan[:OPS]
    hw = g.tensor(g.inputs[0]).shape[1:]
    x = randint((batch, *hw), -128, 128, dev, 0)

    def kernel():
        return tiled.tiled_section(sec, descs, consts, [x])[
            sec.outputs.index(last)]

    def twin():
        env = {g.inputs[0]: x}
        for idx, fn in twin_plan:
            env[idx] = fn(env)
        return env[last]

    outs = [torch.empty((batch, *sec.shapes[o]), dtype=torch.int8, device=dev)
            for o in sec.outputs]

    def plain():
        tiled.tiled_section_plain(sec, consts, [x] + outs)

    yk, yt = kernel(), twin()
    bit = torch.equal(yk, yt)
    rec = {"probe": "448_tiled_stage_ops0-7", "batch": batch,
           "bit_exact_vs_fast": bit,
           "mismatch_frac": None if bit else float((yk != yt).double().mean()),
           "tiled_section_ms": time_ms(kernel, dev, runs),
           "twin_fast_ms": time_ms(twin, dev, runs)}
    rec["speedup"] = rec["twin_fast_ms"] / rec["tiled_section_ms"]
    print(json.dumps(rec), flush=True)
    if not bit:
        raise AssertionError("ops 0-7: the section kernel differs from the "
                             "fast twin")
    plain_ms = time_ms(plain, dev, min(runs, 2))
    macs = 0                     # K*K*Ci a conv output, K*K a depthwise one
    for op in g.ops[:OPS]:
        if op.opname in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            _, kh, kw, ci = g.tensor(op.inputs[1]).data.shape
            oh, ow, co = g.tensor(op.outputs[0]).shape[1:]
            macs += oh * ow * co * kh * kw * (
                ci if op.opname == "CONV_2D" else 1)
    nbytes = x.numel() + sum(t.numel() for t in outs)
    return dict(rec, strips=sec.strips, lowered_ops=sec.end,
                outputs=list(sec.outputs), plain_ms=plain_ms,
                work=[nbytes, batch * macs, 0], device=device_name(dev))


def main(argv: Sequence[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    stage(int(argv[0]) if argv else 256)
    return 0


if __name__ == "__main__":
    sys.exit(main())
