"""Camera-emulation streamer: continuous batched RGB565 frames -> pipeline.

The counterpart of ``yoloface_tpu.host.streamer``: a producer thread feeds
a bounded queue (the batch bytes staged through the native ring,
``native/framepipe.cpp``) while the card runs the previous batch, and each
batch is dispatched before the previous one's detections are read back
(one-deep pipelining).  Frame sources: an image directory (each image
resized to 112x112 RGB565, cycled) or a synthetic moving-pattern
generator.  Output: detection counts and/or firmware-protocol text
(``host/protocol.py``).

On the card, one-deep pipelining takes what JAX's asynchronous dispatch
gave for free (``_Feed``):

  * ``queue_depth`` host slots in pinned memory, allocated once, at the
    first batch; a stager thread pops each batch from the ring straight
    into a free slot and makes no CUDA call;
  * each slot has a device copy, allocated with it on the compute
    stream; the slot's host-to-device copy runs on a copy stream, after
    an event of the kernels that last read the device copy, and records
    an event the compute stream waits on;
  * the consumer hands a slot back only once its copy's event has
    completed;
  * right after dispatching batch k it queues the copy of batch k's four
    detection tensors into pinned host buffers and records an event; the
    drain of batch k-1 waits on that batch's event only, never on a whole
    stream, and reads the pinned buffers.

The consumer starts once the stager has staged ``queue_depth`` batches (or
the source ended), so the copy of batch k+1 can run under batch k's
kernels from the first batch on.  On the CPU (the tests) the slots are
plain tensors the pipeline reads in place and nothing is copied.
"""

from __future__ import annotations

import itertools
import math
import os
import queue
import re
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from yoloface_tpu_torch.host import native, protocol
from yoloface_tpu_torch.pipeline import preprocess

DET_KEYS = ("boxes", "scores", "valid", "count")
_POLL = 0.1       # seconds a blocked thread waits before rechecking _stop
_FACE = re.compile(r"\[Face (\d+)\] BBox: \[(-?\d+), (-?\d+), (-?\d+), "
                   r"(-?\d+)\], Conf: ([\d.]+)")


def protocol_diff(got: str, want: str, boxes, scores, valid,
                  scale: int = 2) -> int:
    """Hold one frame's protocol text ``got`` to a reference's ``want``,
    made from the reference's ``boxes``/``scores``/``valid`` of the frame
    (JAX's, or the CPU path's): equal line by line, except that a face
    line may differ by one unit in a box coordinate whose reference value
    lies within ``head.BOX_ATOL`` of an integer (the text truncates it),
    or in a score within ``head.SCORE_ATOL`` of a two-place rounding edge
    (the head's tolerance, for one ulp of ``exp``).  Raises
    AssertionError otherwise; -> the lines that differed so."""
    from yoloface_tpu_torch.pipeline.head import BOX_ATOL, SCORE_ATOL
    g, w = got.split("\r\n"), want.split("\r\n")
    if len(g) != len(w):
        raise AssertionError(f"{got!r} != {want!r}")
    faces = [(b, s) for b, s, ok in zip(boxes, scores, valid) if ok]
    edge = 0
    for lg, lw in zip(g, w):
        if lg == lw:
            continue
        mg, mw = _FACE.fullmatch(lg), _FACE.fullmatch(lw)
        if not (mg and mw and mg.group(1) == mw.group(1)):
            raise AssertionError(f"{lg!r} != {lw!r}")
        box, score = faces[int(mw.group(1)) - 1]
        for j in range(4):
            a, b, v = int(mg.group(2 + j)), int(mw.group(2 + j)), float(box[j])
            if a != b and not (abs(a - b) == scale
                               and abs(v - round(v)) <= BOX_ATOL):
                raise AssertionError(f"{lg!r} != {lw!r} (box {v!r})")
        a, b, v = float(mg.group(6)), float(mw.group(6)), float(score) * 100
        if a != b and not (abs(a - b) < 0.0101 and abs(
                v - math.floor(v) - 0.5) <= SCORE_ATOL * 100):
            raise AssertionError(f"{lg!r} != {lw!r} (score {score!r})")
        edge += 1
    return edge


def synthetic_frames(batch: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Endless moving-gradient RGB565 frames [batch,112,112] (camera-free
    fixture, like the baked 56x56 test image in Picture.c:1)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:112, 0:112]
    t = 0
    while True:
        phase = (t * 7) % 112
        r = ((xx + phase) % 112 * 2).astype(np.uint8)
        g = ((yy + phase) % 112 * 2).astype(np.uint8)
        b = rng.integers(0, 255, (112, 112), dtype=np.int64).astype(np.uint8)
        rgb = np.stack([r, g, b], axis=-1)
        yield np.stack([preprocess.encode_rgb565(rgb)] * batch)
        t += 1


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading images needs OpenCV (cv2), which is not "
                          "installed") from e
    return cv2


def directory_frames(img_dir: str, batch: int) -> Iterator[np.ndarray]:
    """Cycle a directory of images as 112x112 RGB565 camera frames."""
    cv2 = _cv2()
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not files:
        raise ValueError(f"no images in {img_dir}")
    frames = []
    for f in files:
        img = cv2.imread(os.path.join(img_dir, f))
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        frames.append(preprocess.encode_rgb565(cv2.resize(img, (112, 112))))
    for i in itertools.count():
        sel = [frames[(i * batch + j) % len(frames)] for j in range(batch)]
        yield np.stack(sel)


class _Feed:
    """The device side of a streamer's one-deep pipeline on
    ``pipeline.device``.  On the card: ``depth`` pinned host slots and as
    many device copies of them, allocated once; a slot's host-to-device
    copy on a copy stream, after the kernels that last read its device
    copy (an event), with an event the compute stream waits on; each
    batch's detections copied into pinned host buffers (two sets, taken in
    turn) with an event.  On the CPU the slots are plain tensors the
    pipeline reads in place and nothing is copied."""

    def __init__(self, pipeline, depth: int):
        self.pipeline = pipeline
        self.device = pipeline.device
        self.cuda = self.device.type == "cuda"
        self.depth = depth
        self.slots: List[torch.Tensor] = []
        self._dev: List[torch.Tensor] = []
        self._uploads: List[Optional[torch.cuda.Event]] = []
        self._consumed: List[Optional[torch.cuda.Event]] = []
        self._copy = torch.cuda.Stream(self.device) if self.cuda else None
        self._results: List[Dict[str, torch.Tensor]] = []
        self._turn = 0

    def allocate(self, shape, dtype) -> None:
        """The slots for batches of ``shape`` and numpy ``dtype``, once;
        on the card also their device copies and the detections' pinned
        buffers."""
        t = torch.from_numpy(np.empty(0, dtype)).dtype
        shape = tuple(shape)
        self.slots = [torch.empty(shape, dtype=t, pin_memory=self.cuda)
                      for _ in range(self.depth)]
        self._uploads = [None] * self.depth
        self._consumed = [None] * self.depth
        if self.cuda:
            self._dev = [torch.empty(shape, dtype=t, device=self.device)
                         for _ in range(self.depth)]
            self._results = [self._host_results(shape[0]) for _ in range(2)]

    def _host_results(self, n: int) -> Dict[str, torch.Tensor]:
        """Pinned buffers for ``n`` frames' detections."""
        k = self.pipeline.head_config.max_detections
        return {"boxes": torch.empty((n, k, 4), pin_memory=True),
                "scores": torch.empty((n, k), pin_memory=True),
                "valid": torch.empty((n, k), dtype=torch.bool,
                                     pin_memory=True),
                "count": torch.empty((n,), dtype=torch.int32,
                                     pin_memory=True)}

    def host_bytes(self) -> int:
        """The pinned host memory the slots and result buffers hold."""
        ts = self.slots + [v for r in self._results for v in r.values()]
        return sum(t.numel() * t.element_size() for t in ts)

    def wait_upload(self, j: int) -> None:
        """Block until slot ``j``'s last host-to-device copy has completed,
        so that its bytes may be overwritten."""
        ev = self._uploads[j]
        if ev is not None:
            ev.synchronize()
            self._uploads[j] = None

    def dispatch(self, frames: torch.Tensor, slot: Optional[int] = None):
        """Queue ``frames`` (slot ``slot``'s first frames, or with no slot
        a host batch of its own) through the pipeline -> a handle for
        ``fetch``.  On the card a slot's batch only queues work: the copy
        in, the kernels, the copy out."""
        if not self.cuda:
            return self.pipeline.detect_rgb565_device(frames), None
        compute = torch.cuda.current_stream(self.device)
        n = frames.shape[0]
        if slot is None:      # copied in on the compute stream, unpinned
            det = self.pipeline.detect_rgb565_device(frames.to(self.device))
            host = self._host_results(n)
        else:
            dev = self._dev[slot][:n]
            with torch.cuda.stream(self._copy):
                if self._consumed[slot] is not None:
                    self._copy.wait_event(self._consumed[slot])
                dev.copy_(frames, non_blocking=True)
                up = torch.cuda.Event()
                up.record(self._copy)
            self._uploads[slot] = up
            compute.wait_event(up)
            det = self.pipeline.detect_rgb565_device(dev)
            used = torch.cuda.Event()
            used.record(compute)
            self._consumed[slot] = used
            self._turn ^= 1
            host = {k: v[:n] for k, v in self._results[self._turn].items()}
        for k in DET_KEYS:
            if det[k].shape != host[k].shape:
                raise ValueError(f"{k}: {tuple(det[k].shape)} from the "
                                 f"pipeline, {tuple(host[k].shape)} buffered")
            host[k].copy_(det[k], non_blocking=True)
        done = torch.cuda.Event()
        done.record(compute)
        return host, done

    @staticmethod
    def fetch(handle) -> Dict[str, np.ndarray]:
        """A dispatched batch's detections as numpy arrays (JAX's keys and
        dtypes), once its copy to the host has completed."""
        det, done = handle
        if done is not None:
            done.synchronize()
        return {k: det[k].numpy() for k in DET_KEYS}


class CameraStreamer:
    """Double-buffered producer/consumer around a FacePipeline.

    With ``use_native=True`` (default: auto-detect) frame batch BYTES stage
    through the C++ blocking ring buffer (`native/framepipe.cpp`
    ``fp_ring_*``) — the host-side analogue of the MCU's DMA ping-pong
    buffers — while a Python queue carries only ordering tokens.  Falls back
    to a pure-Python queue when the native library is unavailable.  A
    stager thread moves each batch into one of ``queue_depth`` host slots
    (``_Feed``) that the consumer copies to the card from."""

    def __init__(self, pipeline, source: Iterator[np.ndarray],
                 queue_depth: int = 2, use_native: Optional[bool] = None):
        self.pipeline = pipeline
        self.source = source
        self._stop = threading.Event()
        self._producer: Optional[threading.Thread] = None
        self._stager: Optional[threading.Thread] = None
        self._depth = queue_depth
        self._q: "queue.Queue" = queue.Queue(queue_depth)
        self._ready: "queue.Queue" = queue.Queue()   # staged, in order
        self._free: "queue.Queue" = queue.Queue()    # slots handed back
        if use_native is None:
            use_native = native.available()
        self._use_native = use_native
        self._ring = None
        self._frame_shape = None
        self._frame_dtype = None
        self.feed = _Feed(pipeline, queue_depth)

    def _put(self, token) -> bool:
        """Bounded put that re-checks _stop: if run() finishes while the
        queue is full, the producer must not block forever (thread leak)."""
        while not self._stop.is_set():
            try:
                self._q.put(token, timeout=_POLL)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: "queue.Queue"):
        """Blocking get that re-checks _stop; None once it is set."""
        while not self._stop.is_set():
            try:
                return q.get(timeout=_POLL)
            except queue.Empty:
                continue
        return None

    def _produce(self):
        for frames in self.source:
            if self._stop.is_set():
                break
            if self._use_native and self._ring is None:
                try:
                    self._ring = native.NativeRing(self._depth,
                                                   frames.nbytes)
                    self._frame_shape = frames.shape
                    self._frame_dtype = frames.dtype
                except RuntimeError:
                    self._use_native = False
            if (self._ring is not None
                    and frames.shape == self._frame_shape):
                self._ring.push(np.ascontiguousarray(frames))
                if not self._put(("ring",)):
                    return
            else:
                if not self._put(("arr", frames)):
                    return
        self._put(None)

    def _stage(self):
        """Move each queued batch into a free slot, in queue order: a ring
        batch is popped straight into it; a batch of the slots' shape is
        copied there; any other passes through as it is.  The first batch
        asks the consumer for the slots (a CUDA call, so not made here)."""
        while True:
            token = self._get(self._q)
            if token is None:
                self._ready.put(None)
                return
            frames = None if token[0] == "ring" else token[1]
            shape = self._frame_shape if frames is None else frames.shape
            dtype = self._frame_dtype if frames is None else frames.dtype
            if not self.feed.slots:
                self._ready.put(("alloc", shape, dtype))
            elif frames is not None and (
                    tuple(shape) != tuple(self.feed.slots[0].shape)
                    or np.dtype(dtype) != self.feed.slots[0].numpy().dtype):
                self._ready.put(("arr", frames))
                continue
            j = self._get(self._free)
            if j is None:
                return
            slot = self.feed.slots[j]
            if frames is None:
                if self._ring.pop(out=slot) is None:
                    self._ready.put(None)
                    return
            else:
                np.copyto(slot.numpy(), frames)
            self._ready.put(("slot", j))

    def _next_batch(self):
        """-> (host frames, slot or None) in source order, or None."""
        item = self._ready.get()
        if item is None:
            return None
        if item[0] == "arr":
            return torch.from_numpy(np.ascontiguousarray(item[1])), None
        return self.feed.slots[item[1]], item[1]

    def _prime(self, n_batches: int) -> None:
        """Allocate the slots the stager's first item asks for, then wait
        until it has staged ``min(queue_depth, n_batches)`` batches or has
        ended."""
        first = self._ready.get()
        if first is None:                # an empty source
            self._ready.put(None)
            return
        self.feed.allocate(first[1], first[2])
        for j in range(self._depth):
            self._free.put(j)
        want = min(self._depth, n_batches)
        while self._ready.qsize() < want and self._stager.is_alive():
            time.sleep(0.001)

    def run(self, n_batches: int,
            on_frame: Optional[Callable[[str], None]] = None,
            emit_protocol: bool = True):
        """Run n_batches through the pipeline.  Returns stats dict; calls
        ``on_frame(text)`` per frame with protocol text if requested.

        Execution is pipelined one batch deep: batch k+1 is dispatched to
        the device before batch k's results are fetched to the host — the
        compute/IO overlap the MCU gets from its DMA double buffers."""
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._stager = threading.Thread(target=self._stage, daemon=True)
        self._producer.start()
        self._stager.start()
        frame_no = 0
        total_faces = 0
        t0 = time.perf_counter()
        frames_done = 0
        pending = None   # (handle, batch_size) in flight
        self._prime(n_batches)

        def drain(handle, size):
            nonlocal frame_no, total_faces, frames_done
            det = self.feed.fetch(handle)
            if emit_protocol and on_frame is not None:
                for i in range(size):
                    frame_no += 1
                    total_faces += int(det["count"][i])
                    on_frame(protocol.encode_frame(
                        frame_no, det["boxes"][i], det["scores"][i],
                        det["valid"][i]))
            else:
                frame_no += size
                total_faces += int(det["count"].sum(dtype=np.int64))
            frames_done += size

        for _ in range(n_batches):
            item = self._next_batch()
            if item is None:
                break
            frames, slot = item
            handle = self.feed.dispatch(frames, slot)
            if pending is not None:
                drain(*pending)
            if slot is not None:
                self.feed.wait_upload(slot)
                self._free.put(slot)
            pending = (handle, frames.shape[0])
        if pending is not None:
            drain(*pending)
        dt = time.perf_counter() - t0
        self._stop.set()
        if self._ring is not None:
            self._ring.close()
        return {"frames": frames_done, "faces": total_faces,
                "seconds": dt, "native_ring": self._ring is not None,
                "fps": frames_done / dt if dt > 0 else float("inf")}

    def stop(self):
        self._stop.set()


class PyScheduler:
    """Pure-Python fallback with NativeScheduler's exact semantics (used
    when the C++ library is unavailable; parity held by
    tests/test_torch_native.py)."""

    def __init__(self, n_streams: int, frame_shape, frame_dtype,
                 batch: int, capacity: Optional[int] = None):
        self.n_streams = n_streams
        self.batch = batch
        self.frame_shape = tuple(frame_shape)
        self.frame_dtype = np.dtype(frame_dtype)
        self._cap = capacity if capacity is not None else 4 * batch
        self._q: list = []
        self._seq = [0] * n_streams
        self._closed = False
        self._mu = threading.Condition()

    def push(self, stream_id: int, frame: np.ndarray) -> bool:
        if not 0 <= stream_id < self.n_streams:
            raise ValueError(f"bad stream id {stream_id}")
        with self._mu:
            while len(self._q) >= self._cap and not self._closed:
                self._mu.wait(_POLL)
            if self._closed:
                return False
            self._q.append((stream_id, self._seq[stream_id],
                            np.array(frame, self.frame_dtype, copy=True)))
            self._seq[stream_id] += 1
            self._mu.notify_all()
            return True

    def next_batch(self, out=None):
        """As ``NativeScheduler.next_batch``: with ``out`` (``batch``
        frames, a numpy array or CPU tensor) the frames are written there
        and ``out[:take]`` is returned as the frames."""
        with self._mu:
            while len(self._q) < self.batch and not self._closed:
                self._mu.wait(_POLL)
            take = min(len(self._q), self.batch)
            if take == 0:
                return None
            items, self._q = self._q[:take], self._q[take:]
            self._mu.notify_all()
        frames = np.stack([f for _, _, f in items])
        if out is not None:
            view = out.numpy() if isinstance(out, torch.Tensor) else out
            np.copyto(view[:take], frames)
            frames = out[:take]
        return (frames, np.array([s for s, _, _ in items], np.int32),
                np.array([q for _, q, _ in items], np.int64))

    def pending(self) -> int:
        with self._mu:
            return len(self._q)

    def close(self):
        with self._mu:
            self._closed = True
            self._mu.notify_all()


def make_scheduler(n_streams: int, frame_shape, frame_dtype, batch: int,
                   capacity: Optional[int] = None,
                   use_native: Optional[bool] = None):
    """NativeScheduler when the C++ library is available, else PyScheduler."""
    if use_native is None:
        use_native = native.available()
    if use_native:
        return native.NativeScheduler(n_streams, frame_shape, frame_dtype,
                                      batch, capacity)
    return PyScheduler(n_streams, frame_shape, frame_dtype, batch, capacity)


class MultiCameraStreamer:
    """Many camera streams -> one batch stream on the card -> per-camera
    results.

    The serving generalization of :class:`CameraStreamer`: per-stream
    producer threads feed the (C++) multi-stream scheduler, which
    assembles fixed-size batches in arrival order with (stream, seq) tags;
    the consumer takes each batch straight into one of two host slots
    (pinned on the card), runs the pipeline once per batch and
    demultiplexes detections back to their cameras.

    ``sources``: one iterator of single [112,112] uint16 frames per camera.
    """

    def __init__(self, pipeline, sources, batch: int,
                 use_native: Optional[bool] = None):
        self.pipeline = pipeline
        self.sources = list(sources)
        self.batch = batch
        self.sched = make_scheduler(len(self.sources), (112, 112),
                                    np.uint16, batch,
                                    use_native=use_native)
        self._threads: list = []
        self._stop = threading.Event()
        self.feed = _Feed(pipeline, 2)

    def _produce(self, sid: int, source):
        for frame in source:
            if self._stop.is_set():
                return
            if not self.sched.push(sid, frame):
                return

    def run(self, n_batches: int,
            on_frame: Optional[Callable[[int, int, str], None]] = None):
        """Consume n_batches; ``on_frame(stream_id, seq, text)`` receives
        the protocol line per frame.  Returns per-stream stats."""
        for sid, src in enumerate(self.sources):
            t = threading.Thread(target=self._produce, args=(sid, src),
                                 daemon=True)
            t.start()
            self._threads.append(t)

        n_streams = len(self.sources)
        frames_per_stream = [0] * n_streams
        faces_per_stream = [0] * n_streams
        t0 = time.perf_counter()
        done = 0
        pending = None      # (handle, stream ids, seqs)
        if not self.feed.slots:
            self.feed.allocate((self.batch, 112, 112), np.uint16)

        def drain(handle, sids, seqs):
            det = self.feed.fetch(handle)
            for s, v in enumerate(np.bincount(sids, minlength=n_streams)):
                frames_per_stream[s] += int(v)
            for s, v in enumerate(np.bincount(
                    sids, det["count"].astype(np.int64), n_streams)):
                faces_per_stream[s] += int(v)
            if on_frame is not None:
                for i, (sid, seq) in enumerate(zip(sids, seqs)):
                    on_frame(int(sid), int(seq), protocol.encode_frame(
                        int(seq) + 1, det["boxes"][i], det["scores"][i],
                        det["valid"][i]))

        for k in range(n_batches):
            slot = k % 2
            self.feed.wait_upload(slot)
            nb = self.sched.next_batch(out=self.feed.slots[slot])
            if nb is None:
                break
            frames, sids, seqs = nb
            handle = self.feed.dispatch(frames, slot)
            if pending is not None:
                drain(*pending)
            pending = (handle, sids, seqs)
            done += 1
        if pending is not None:
            drain(*pending)
        self._stop.set()
        self.sched.close()
        dt = time.perf_counter() - t0
        total = sum(frames_per_stream)
        return {"batches": done, "frames": total,
                "frames_per_stream": frames_per_stream,
                "faces_per_stream": faces_per_stream,
                "seconds": dt,
                "fps": total / dt if dt > 0 else float("inf"),
                "native": type(self.sched).__name__ == "NativeScheduler"}
