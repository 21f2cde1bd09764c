"""Hopper counterparts of the JAX package's ``tools/`` probes (B9).

Each runs on the card, from the root of the checkout::

    python3 -m yoloface_tpu_torch.probes.microbench [conv1x1|whcn|inkernel|dw16|packdot] [args]
    python3 -m yoloface_tpu_torch.probes.microbench [batch C S]
    python3 -m yoloface_tpu_torch.probes.probe448_micro [2|sweep]
    python3 -m yoloface_tpu_torch.probes.probe448 [batch]
    python3 -m yoloface_tpu_torch.probes.debug448 fix|rep|min [batch]

and takes the JAX tool's arguments and defaults.  Their kernels are in
``kernels/probes.py`` (``csrc/probe_{copy,dw,conv}.cu``) and, for
``probe448``, the tiled section kernel B6.  Every probe first holds each
kernel variant against its plain version bit for bit on the input it is
timed on, then times it (CUDA events; a chained probe feeds each call's
output to the next call, as the JAX tools chain their calls inside one
jit; ``probe448_micro``, whose bytes fit the L2, times each variant with
the L2 cold and L2-resident beside the launch floor) and prints the JAX
tool's lines with each variant's bound beside them.  A variant that fails
raises.  The functions return their numbers as a dict; they default to the
card and raise without one, and take ``device="cpu"`` (the plain versions,
host-clock times that are not device times) for the tests.

``bound`` is the yardstick of every kernel row, ``chip_smoke.py``'s
included.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

# the H100 SXM's published peaks: HBM bytes/s; int8 tensor-core ops/s (2 a
# multiply-add); float32 outside the tensor cores, the most the CUDA cores'
# compares and integer ops could reach
HBM_RATE, INT8_RATE, CORE_RATE = 3.35e12, 1979e12, 67e12
# a spin on the stream before the timed window, long enough for the host to
# queue the timed calls behind it: the window then holds device time alone
CYCLES_PER_S = 2.0e9               # above the H100's 1.98 GHz boost clock
LEAD_S, LEAD_MAX_S = 1e-3, 0.2
# a cold window: a read of FLUSH_BYTES (four times the H100's 50 MB L2)
# before its spin evicts what the last call left in the L2
FLUSH_BYTES = 4 * 50 * 2 ** 20


def card(device="cuda") -> torch.device:
    """The device the probe runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card; pass device='cpu' "
                           "for the plain versions")
    return dev


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu, host clock")


def bound(nbytes: float, macs: float = 0, core_ops: float = 0
          ) -> Tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over the HBM rate and the operations over
    their peak (multiply-adds on the int8 tensor cores, other integer ops
    at the CUDA cores' rate, each unit at its own peak at once)."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = max(2 * macs / INT8_RATE, core_ops / CORE_RATE) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn: Callable[[], object], dev: torch.device,
            runs: int = 3, cold: bool = False) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs after two
    warm-ups: CUDA events on the card, the host clock on the CPU.  On the
    card each timed window opens behind a spin of twice the host's time to
    queue ``fn`` (read on the second warm-up; ``LEAD_S`` at least), so the
    wrappers' host work falls outside it while the queue stays ahead.
    ``cold``: before each spin, outside the window, a read of four times
    the L2 (a reduction: reads alone, so no dirty line is left to write
    back inside the window), so the window finds nothing of the last call
    in the L2; else (warm) a call may find what the one before it left
    there (on the CPU, nothing changes)."""
    flush = (torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
             if cold and dev.type == "cuda" else None)
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    lead = min(max(2 * (time.perf_counter() - t0), LEAD_S), LEAD_MAX_S)
    _sync(dev)
    times = []
    for _ in range(runs):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if flush is not None:
                torch.amax(flush)
            torch.cuda._sleep(int(lead * CYCLES_PER_S))
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def launch_floor_ms(dev: torch.device, runs: int = 3,
                    cold: bool = False) -> float:
    """The window ``time_ms`` puts around a call, on the NHWC 1x1's row
    kernel (``probe_conv(..., variant="mma_rows")``) over one row of 8
    int8 channels to 8 wrapped: what a launch costs between the events
    when it moves next to nothing (on the CPU, the plain version's host
    time)."""
    from yoloface_tpu_torch.kernels import probes as K
    x = torch.ones((1, 8), dtype=torch.int8, device=dev)
    w = torch.ones((8, 8), dtype=torch.int8, device=dev)
    return time_ms(lambda: K.probe_conv(x, w, variant="mma_rows",
                                        epi="wrap"), dev, runs, cold)


def time_chain(call: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor, reps: int = 20, runs: int = 3) -> float:
    """Milliseconds a call of ``call`` in a chain of ``reps`` calls, each
    fed the last one's output (median of ``runs`` chains)."""
    def chain():
        v = x
        for _ in range(reps):
            v = call(v)
        return v
    return time_ms(chain, x.device, runs) / reps


def same(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Raise unless ``got`` equals ``want`` bit for bit; -> 0.0, the
    largest absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(got, want):
        bad = (got.shape == want.shape and got.dtype == want.dtype)
        detail = (f"{int((got != want).sum())} of {got.numel()} differ"
                  if bad else f"{tuple(got.shape)} {got.dtype} against "
                  f"{tuple(want.shape)} {want.dtype}")
        raise AssertionError(f"{what}: kernel and plain version differ "
                             f"({detail})")
    return 0.0


def randint(shape, lo: int, hi: int, dev: torch.device, seed: int,
            dtype=torch.int8) -> torch.Tensor:
    """Integers in [lo, hi) made on ``dev`` from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(lo, hi, tuple(shape), generator=gen, device=dev,
                         dtype=dtype)


def variant(ms: float, work: Tuple[float, float, float],
            **extra) -> Dict[str, object]:
    """A variant's record: its time, its work (bytes, multiply-adds, other
    operations) and the bound they give."""
    b = bound(*work)
    return dict(ms=ms, bound_ms=b[0], bound_by=b[1], work=list(work),
                **extra)


def record(probe: str, headline: str, variants: Dict, plain_ms: float,
           err: float, dev: torch.device, library_ms: Optional[float] = None,
           **extra) -> Dict[str, object]:
    """A probe's result: its variants' records, the one that heads its
    kernels row, the plain version's time at that variant's shape, the
    largest kernel-against-plain difference (0.0) and the device."""
    return dict(probe=probe, headline=headline, variants=variants,
                plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err,
                device=device_name(dev), **extra)


def show(name: str, rec: Dict[str, object], width: int = 30,
         per: float = 1.0, gmac: Optional[float] = None,
         extra: str = "") -> None:
    """One line in the JAX tool's form (``ms/op``, ``GMAC/ms``), the bound
    beside it."""
    ms = rec["ms"] / per
    line = f"{name:>{width}s}: {ms:7.3f} ms/op"
    if gmac:
        line += f" ({gmac / rec['ms']:6.1f} GMAC/ms{extra})"
    elif extra:
        line += f" ({extra.lstrip(', ')})"
    print(line + f"; bound {rec['bound_ms'] / per:.4f} ms ({rec['bound_by']})",
          flush=True)


def show_attrs(name: str, attrs: Dict[str, int]) -> None:
    """A kernel instantiation's registers and local bytes (a spill shows
    as local bytes), as built for the card."""
    print(f"{'':>4s}[attrs] {name}: {attrs['registers']} registers a "
          f"thread, {attrs['local_bytes']} B local, {attrs['blocks_per_sm']}"
          " blocks an SM", flush=True)
