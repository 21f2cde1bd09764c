"""The work each layer must do for one frame, and the card's peaks.

Counted from the configuration's graph as the benchmark's own reader parses
it, never from the program.  A layer's least time is the larger of the
bytes it must move (its inputs read once, its outputs written once; the
net's weights, 50 kB a batch, left out) over the memory bandwidth and
twice its multiply-adds over the int8 tensor-core peak.  Every op kind
is priced at that one peak, so no implementation of a layer, on any unit
of the card, can read above 100% of its bound.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import frames, named
from benchmark.reference import tflite

# NVIDIA H100 SXM, dense, at its 700 W limit (the published data sheet)
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15


def graph_of(config: dict, root) -> dict:
    """The configuration's graph, read by ``benchmark/graphs/<kind>.py``."""
    spec = config["graph"]
    return named.module("graphs", spec["kind"]).read(spec, root)


def per_frame(config: dict, traffic: dict, graph: dict) -> dict:
    """layer -> {"bytes", "macs"} of one frame; the preprocess only where
    the entry makes the net's input from the traffic's frames, the head
    only where the configuration decodes."""
    t = graph["tensors"]
    inp = int(np.prod(t[graph["inputs"][0]]["shape"][1:]))
    out = int(np.prod(t[graph["outputs"][0]]["shape"][1:]))
    work = {"net": {"bytes": inp + out,
                    "macs": tflite.macs_per_frame(graph)}}
    if "decode" in config:
        # the int8 head tensor in; boxes (4 float32), scores (float32) and
        # valid (bool) of K slots and the int32 count out
        k = config["decode"]["max_detections"]
        work["head"] = {"bytes": out + k * (16 + 4 + 1) + 4, "macs": 0}
    kind = frames.maker(traffic)
    if kind.PREPROCESSED:
        work["preprocess"] = {"bytes": kind.BYTES + inp, "macs": 0}
    return work


def bound_s(w: dict) -> float:
    """The least seconds one frame of the layer can take."""
    return max(w["bytes"] / HBM_BYTES_S, 2 * w["macs"] / INT8_OPS_S)
