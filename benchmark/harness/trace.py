"""The traced window, reduced to what the per-layer metrics read.

``torch.profiler`` (CPU and CUDA activities) records the window; its
Chrome trace is read back as plain events.  Device operations are the
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; host activity is the
``user_annotation`` spans (the window's ``bench.*`` spans) and the
``cpu_op`` events inside them.  Everything is clipped to the
``bench.window`` span, which holds the window and the drain after it, so
every kernel of every batch submitted in it lies inside.

Kernels map to layers by name (``LAYERS``): the RGB565 preprocess, the
head, PyTorch's own kernels (``LIBRARY``: ``at::`` and the libraries'
namespaces), and every other kernel to the net, so a kernel that a later change adds to the net
is counted there without an edit here.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

LAYERS = (("preprocess", ("preprocess_rgb565",)),
          ("head", ("detect_head", "topk_conf")))
# PyTorch's and its libraries' kernels: their short names start so
LIBRARY = ("at::", "cub::", "cutlass::", "cublas", "nvjet", "sm90_")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def layer_of(name: str) -> str:
    """``preprocess``, ``head``, ``torch`` or ``net`` for a kernel's full
    name."""
    name = short(name)
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return "torch" if name.startswith(LIBRARY) else "net"


def short(name: str) -> str:
    """A kernel's name without ``void``, ``(anonymous namespace)::`` and
    its argument list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for k, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:k]
    return name


class Trace:
    """The device operations and host spans of one traced window."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == "bench.window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no bench.window span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"],
             e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and self.t0 <= float(e["ts"]) < self.t1)
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"],
             e["name"]) for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op"))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self):
        """The union of the device operations' intervals, in order."""
        segs = []
        for a, b, _, _ in self.ops:
            b = min(b, self.t1)
            if segs and a <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], b)
            else:
                segs.append([a, b])
        return segs

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy()) * 1e-6

    def layer_s(self, layer: str) -> float:
        """Device seconds of the layer's kernels."""
        return sum(b - a for a, b, cat, name in self.ops
                   if cat == "kernel" and layer_of(name) == layer) * 1e-6

    def kernel_names(self) -> set:
        return {name for _, _, cat, name in self.ops if cat == "kernel"}

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for a, b, cat, name in self.ops:
            by[short(name) if cat == "kernel" else cat] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle device seconds summed by what the host was doing when each
        gap began (the innermost ``bench.*`` span and the innermost PyTorch
        op inside it), the largest first."""
        by = defaultdict(float)
        active, k, last = [], 0, self.t0
        for a, b in self._busy() + [[self.t1, self.t1]]:
            if a > last:
                while k < len(self.host) and self.host[k][0] <= last:
                    active.append(self.host[k])
                    k += 1
                active = [e for e in active if e[1] > last]
                span = [n for _, _, c, n in active
                        if c == "user_annotation" and n != "bench.window"]
                ops = [n for _, _, c, n in active if c == "cpu_op"]
                doing = "/".join(x[-1] for x in (span, ops) if x)
                by[doing or "outside any span"] += (a - last) * 1e-6
            last = max(last, b)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def profiled(fn, cuda: bool = True):
    """Run ``fn()`` under ``torch.profiler`` (the CPU's activity alone
    where ``cuda`` is false); return its result and the ``Trace`` of what
    it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)
