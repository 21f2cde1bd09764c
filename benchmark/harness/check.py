"""What decides ``correct``: the timed path's outputs against the plain
reference.

For every batch the window's reservoir kept, the reference (``benchmark/
reference``: the benchmark's own tflite reader, int8 ops and head, plain
torch in blocks of frames) recomputes from the same frames, which the
harness made: the int8 network input where the entry makes it (an RGB565
entry's preprocess), the int8 head tensor in the traffic's bits, and the
detections where the configuration has a ``decode``.  The numbers
compared, summed or maximized over the kept batches:

* ``input_bytes_differ``: int8 input bytes that differ from the
  reference's (entries that make the input; exact, limit 0);
* ``head_bytes_differ``: int8 head bytes that differ (exact, limit 0);
* ``frames_dets_differ``: frames whose valid slots or count differ
  (exact, limit 0);
* ``box_gap_px``, ``score_gap``: the largest gap of a box coordinate and of
  a score over every slot (invalid slots are 0 on both sides), against the
  configuration's limits.
"""

from __future__ import annotations

import torch

from benchmark.reference import head as ref_head
from benchmark.reference.int8 import int4_grid, rgb565_to_int8
from benchmark.reference.net import Net

EXACT = ("input_bytes_differ", "head_bytes_differ", "frames_dets_differ")


class Reference:
    """The reference of one configuration in the given bits."""

    def __init__(self, config: dict, graph: dict, bits: str, device,
                 weight_bits: int = 8):
        self.config, self.device = config, device
        self.net = Net(graph, bits, device, weight_bits)
        out = graph["tensors"][graph["outputs"][0]]
        self.scale, self.zp = float(out["scales"][0]), int(out["zps"][0])

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> dict:
        """``x`` (where the frames are RGB565), ``y`` and ``dets`` (where
        the configuration decodes)."""
        made = frames.dtype == torch.uint16
        x = rgb565_to_int8(frames) if made else frames
        y = self.net(x, self.config["reference_block"])
        if self.net.weight_bits == 4:
            x = int4_grid(x)
        out = {"y": y}
        if made:
            out["x"] = x
        if "decode" in self.config:
            out["dets"] = ref_head.detect(y, scale=self.scale,
                                          zero_point=self.zp,
                                          head=self.config["decode"])
        return out


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared for one batch (see the module's docstring):
    each output that the reference computed."""
    values = {"head_bytes_differ": int((prog["y"] != ref["y"]).sum())}
    if "x" in ref:
        values["input_bytes_differ"] = int((prog["x"] != ref["x"]).sum())
    if "dets" in ref:
        pd, rd = prog["dets"], ref["dets"]
        values.update(
            frames_dets_differ=int(((pd["valid"] != rd["valid"]).any(-1)
                                    | (pd["count"] != rd["count"])).sum()),
            box_gap_px=float((pd["boxes"] - rd["boxes"]).abs().max()),
            score_gap=float((pd["scores"] - rd["scores"]).abs().max()))
    return values


def merge(per_batch: list) -> dict:
    """Counts summed, gaps maximized, over the batches."""
    out = {}
    for values in per_batch:
        for k, v in values.items():
            out[k] = (out.get(k, 0) + v) if k in EXACT else max(
                out.get(k, 0.0), v)
    return out


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit; an exact count's limit is 0."""
    checks = {k: {"value": v, "limit": 0 if k in EXACT else limits[k]}
              for k, v in sorted(values.items())}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def detections_seen(ref: dict) -> tuple:
    """(frames with at least one face, faces) of the reference's
    detections: what the check compared on (0, 0 with no decode)."""
    if "dets" not in ref:
        return 0, 0
    count = ref["dets"]["count"]
    return int((count > 0).sum()), int(count.sum())
