"""The measured window: one client in a closed loop.

The client keeps ``inflight`` batches in flight.  It submits a batch
through the entry, records a CUDA event after the entry returns, and
submits the next batch when the host sees the oldest one's event
complete.  Batch ``i`` takes pool batch ``i % len(pool)``; the frames are
already on the card.  The window lasts ``seconds`` from the first timed
submission: a batch counts if the host saw it complete inside it; the
batches still in flight at the close are drained after it and not
counted.  Spans (``torch.profiler.record_function``) name what the host
is doing: ``bench.submit`` (the entry call and the event), ``bench.wait``
(waiting for the oldest batch), ``bench.drain``.

The engine's int8 input and head tensor and the detections of every batch
are held until it completes; a reservoir drawn from the seed then keeps
``keep`` of the completed batches for the check.
"""

from __future__ import annotations

import random
import time
from collections import deque

import torch
from torch.profiler import record_function


class _Done:
    """A completion that has already happened (a CPU run)."""

    def synchronize(self):
        pass


def _event(device):
    if device.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn by ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def run(program, pool, inflight: int, seconds: float, device,
        sample: Reservoir, start_index: int = 0) -> dict:
    """Drive the closed loop for ``seconds``; return the completed
    batches' (submitted_s, completed_s, frames), the host seconds of each
    entry call, the number submitted in the window and its start."""
    q = deque()
    state = {"i": start_index, "submit_s": []}

    def submit():
        i = state["i"]
        with record_function("bench.submit"):
            t0 = time.perf_counter()
            out = program(pool[i % len(pool)])
            ev = _event(device)
            state["submit_s"].append(time.perf_counter() - t0)
        q.append((i, t0, ev, out))
        state["i"] = i + 1

    done = []
    start = time.perf_counter()
    end = start + seconds
    for _ in range(inflight):
        submit()
    while True:
        i, sub, ev, out = q.popleft()
        with record_function("bench.wait"):
            ev.synchronize()
        t = time.perf_counter()
        if t > end:
            break
        done.append((sub, t, pool[i % len(pool)].shape[0]))
        sample.offer((i, out))
        submit()
    with record_function("bench.drain"):
        for _, _, ev, _ in q:
            ev.synchronize()
    submitted = state["i"] - start_index
    q.clear()
    return {"batches": done, "submit_s": state["submit_s"],
            "submitted": submitted, "start": start}
