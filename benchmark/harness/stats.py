"""The end-to-end arithmetic on a window's batches.

``frames_per_s``: every frame of every batch whose completion the host saw
inside the window, over the window's length.  ``batch_ms_p95``: the 95th
percentile of the latencies of all those batches (``statistics.quantiles``,
inclusive method), never of medians of chunks.  A batch's latency runs from
the host clock at its submission to the moment the host sees its
completion event.
"""

from __future__ import annotations

import statistics


def frames_per_s(batches, window_s: float) -> float:
    """``batches``: (submitted_s, completed_s, frames) of the batches
    completed in the window."""
    return sum(f for _, _, f in batches) / window_s


def batch_ms_p95(batches) -> float:
    lat = [(done - sub) * 1e3 for sub, done, _ in batches]
    if len(lat) < 2:
        raise ValueError("a p95 needs at least two batches")
    return statistics.quantiles(lat, n=100, method="inclusive")[94]

