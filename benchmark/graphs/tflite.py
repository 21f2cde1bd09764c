"""The reference's graph of a configuration whose ``graph`` has the kind
``tflite``: the benchmark's own reader of the int8 ``.tflite`` at
``file``, retargeted spatially by ``retarget`` (1: as published)."""

from __future__ import annotations

from benchmark.reference import tflite


def read(spec: dict, root) -> dict:
    g = tflite.read(root / spec["file"])
    return tflite.retarget(g, spec["retarget"]) if spec["retarget"] != 1 \
        else g
