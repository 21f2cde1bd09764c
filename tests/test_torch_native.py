"""The port's native frame pipeline (``yoloface_tpu_torch/host/native.py``)
against the JAX package: the C++ library and the Python fallbacks give the
bytes of JAX's ``pipeline.preprocess`` and ``host.protocol``; the ring
keeps FIFO order, blocks and applies backpressure, and ``pop(out=...)``
fills a buffer in place; the native and Python schedulers match JAX's
Python scheduler in integrity and order.  The library is built from
``native/framepipe.cpp`` into the git-ignored ``build/``; the tracked
``native/libframepipe.so`` is never written.  The JAX package's native
module is not called here: it runs ``make -C native``, which rewrites the
tracked library."""

import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from yoloface_tpu.host import protocol as jprotocol
from yoloface_tpu.host.streamer import PyScheduler as JaxPyScheduler
from yoloface_tpu.pipeline import preprocess as jpre
from yoloface_tpu_torch.host import native, streamer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED = os.path.join(REPO, "native", "libframepipe.so")
IMPLS = ["native", "python"]


@pytest.fixture
def impl(request, monkeypatch):
    """``native``: the C++ library (skipped without a compiler);
    ``python``: the fallbacks, as without one."""
    if request.param == "native":
        if not native.available():
            pytest.skip(f"no native build here: {native.build_error}")
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_preprocess_bit_parity(impl):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 1 << 16, (5, 112, 112),
                          dtype=np.int64).astype(np.uint16)
    got = native.rgb565_to_int8(frames)
    want = np.asarray(jpre.rgb565_to_int8_input(frames))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_encode_rgb565_parity(impl):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (2, 112, 112, 3),
                       dtype=np.int64).astype(np.uint8)
    np.testing.assert_array_equal(native.encode_rgb565(rgb),
                                  jpre.encode_rgb565(rgb))
    np.testing.assert_array_equal(native.encode_rgb565(rgb[0]),
                                  jpre.encode_rgb565(rgb[:1]))


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_protocol_byte_parity(impl):
    """Seeded detections (boxes anywhere in the 56x56 frame, scores in
    [0, 1), some slots invalid) give JAX ``protocol.encode_frame``'s
    bytes, frame by frame."""
    rng = np.random.default_rng(2)
    for frame_no in range(1, 21):
        k = int(rng.integers(1, 17))
        boxes = rng.uniform(0, 56, (k, 4)).astype(np.float32)
        scores = rng.uniform(0, 1, k).astype(np.float32)
        valid = rng.random(k) < 0.6
        assert native.encode_frame(frame_no, boxes, scores, valid) == \
            jprotocol.encode_frame(frame_no, boxes, scores, valid)


def test_ring_buffer_fifo_and_blocking():
    if not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    ring = native.NativeRing(capacity=2, slot_bytes=16)
    ring.push(np.arange(16, dtype=np.uint8))
    ring.push(np.arange(16, 32, dtype=np.uint8))
    assert len(ring) == 2
    assert ring.pop() == bytes(range(16))
    assert ring.pop() == bytes(range(16, 32))

    got = []
    t = threading.Thread(target=lambda: got.append(ring.pop()))
    t.start()
    ring.push(np.full(16, 7, np.uint8))
    t.join(timeout=5)
    assert not t.is_alive()
    assert got[0] == bytes([7] * 16)

    ring.close()
    assert ring.pop() is None


def test_ring_buffer_backpressure():
    """A full ring blocks the producer until the consumer pops."""
    if not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    ring = native.NativeRing(capacity=1, slot_bytes=8)
    ring.push(np.zeros(8, np.uint8))
    done = threading.Event()

    def producer():
        ring.push(np.ones(8, np.uint8))
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    assert not done.wait(timeout=0.2)
    assert ring.pop() == bytes(8)
    assert done.wait(timeout=5)
    t.join(timeout=5)
    assert not t.is_alive()
    assert ring.pop() == bytes([1] * 8)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_ring_pop_out_fills_in_place(kind):
    """``pop(out=...)`` writes the slot into the caller's buffer (a numpy
    array or a CPU tensor, as the streamer's slots) and returns the count
    written; a closed, drained ring gives None and leaves it alone."""
    if not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    frames = np.random.default_rng(3).integers(
        0, 1 << 16, (3, 112, 112), dtype=np.int64).astype(np.uint16)
    ring = native.NativeRing(2, frames.nbytes)
    ring.push(frames)
    ring.push(frames[::-1])
    out = (np.zeros_like(frames) if kind == "numpy"
           else torch.zeros(frames.shape, dtype=torch.uint16))
    view = out if kind == "numpy" else out.numpy()
    ptr = view.ctypes.data
    assert ring.pop(out=out) == frames.nbytes
    np.testing.assert_array_equal(view, frames)
    assert ring.pop(out=out) == frames.nbytes
    np.testing.assert_array_equal(view, frames[::-1])
    assert view.ctypes.data == ptr
    ring.close()
    assert ring.pop(out=out) is None
    np.testing.assert_array_equal(view, frames[::-1])


def test_ring_pop_out_refuses_a_short_or_strided_buffer():
    if not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    ring = native.NativeRing(1, 64)
    ring.push(np.zeros(64, np.uint8))
    with pytest.raises(ValueError, match="needs 64"):
        ring.pop(out=np.empty(63, np.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        ring.pop(out=np.empty(128, np.uint8)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        ring.pop(out=torch.empty(128, dtype=torch.uint8)[::2])
    assert len(ring) == 1


def _sched(impl, *args, **kw):
    return streamer.make_scheduler(*args, use_native=impl == "native", **kw)


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_multistream_scheduler_integrity(impl):
    """N producer threads push tagged frames; batches keep frame bytes,
    stream ids, per-stream order and completeness."""
    n_streams, per_stream, batch = 3, 20, 6
    sched = _sched(impl, n_streams, (4, 4), np.uint16, batch)

    def produce(sid):
        for seq in range(per_stream):
            assert sched.push(sid, np.full((4, 4), sid * 1000 + seq,
                                           np.uint16))

    threads = [threading.Thread(target=produce, args=(s,))
               for s in range(n_streams)]
    for t in threads:
        t.start()
    got = {s: [] for s in range(n_streams)}
    total = 0
    while total < n_streams * per_stream:
        frames, sids, seqs = sched.next_batch()
        assert len(frames) == batch
        for f, sid, seq in zip(frames, sids, seqs):
            assert int(f[0, 0]) == sid * 1000 + seq and (f == f[0, 0]).all()
            got[int(sid)].append(int(seq))
            total += 1
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    for s in range(n_streams):
        assert got[s] == list(range(per_stream))
    sched.close()
    assert sched.next_batch() is None


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_scheduler_equals_jax_on_the_same_pushes(impl):
    """One thread pushes the same interleaving of 3 streams into the
    port's scheduler and JAX's Python one: every batch (frames, stream
    ids, seqs) is equal, the partial last batch included after close."""
    rng = np.random.default_rng(4)
    order = rng.integers(0, 3, 23)
    frames = rng.integers(0, 1 << 16, (23, 2, 3),
                          dtype=np.int64).astype(np.uint16)
    ours = _sched(impl, 3, (2, 3), np.uint16, 5, capacity=30)
    theirs = JaxPyScheduler(3, (2, 3), np.uint16, 5, capacity=30)
    for sid, f in zip(order, frames):
        assert ours.push(int(sid), f) and theirs.push(int(sid), f)
    assert ours.pending() == theirs.pending() == 23
    ours.close()
    theirs.close()
    while True:
        a, b = ours.next_batch(), theirs.next_batch()
        if b is None:
            assert a is None
            break
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_scheduler_next_batch_out_fills_in_place(impl):
    """``next_batch(out=...)`` writes the batch's frames into the caller's
    buffer (a CPU tensor, as the streamer's slot) and returns its first
    ``take`` frames as the frames."""
    sched = _sched(impl, 2, (112, 112), np.uint16, 4)
    frames = np.random.default_rng(5).integers(
        0, 1 << 16, (6, 112, 112), dtype=np.int64).astype(np.uint16)
    for k, f in enumerate(frames):
        sched.push(k % 2, f)
    out = torch.zeros((4, 112, 112), dtype=torch.uint16)
    got, sids, seqs = sched.next_batch(out=out)
    assert isinstance(got, torch.Tensor) and got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(out.numpy(), frames[:4])
    assert sids.tolist() == [0, 1, 0, 1] and seqs.tolist() == [0, 0, 1, 1]
    sched.close()
    got, sids, seqs = sched.next_batch(out=out)
    assert got.shape[0] == 2
    np.testing.assert_array_equal(got.numpy(), frames[4:])
    assert sids.tolist() == [0, 1] and seqs.tolist() == [2, 2]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_native_build_lies_in_build_dir():
    """The port compiles ``native/framepipe.cpp`` into
    ``build/yoloface_tpu_torch/`` (git-ignored) and never writes the
    tracked ``native/libframepipe.so``."""
    if not native.available():
        pytest.skip(f"no native build here: {native.build_error}")
    before = _sha(TRACKED)
    lib = native.build().resolve()
    build = os.path.join(REPO, "build") + os.sep
    assert str(lib).startswith(build), lib
    assert native.SOURCE == native.SOURCE.parents[1] / "native" / \
        "framepipe.cpp"
    assert str(native.SOURCE).startswith(os.path.join(REPO, "native"))
    assert _sha(TRACKED) == before
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_without_a_compiler_the_python_fallbacks_serve(monkeypatch):
    """As in the JAX package, no compiler means the Python fallbacks:
    ``available()`` is false, ``build_error`` names the compiler, the
    ring refuses, ``make_scheduler`` gives the Python scheduler."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    assert not native.available()
    assert "no-such-compiler-here" in native.build_error
    with pytest.raises(RuntimeError, match="unavailable"):
        native.NativeRing(2, 16)
    assert isinstance(streamer.make_scheduler(2, (4, 4), np.uint16, 2),
                      streamer.PyScheduler)
    frames = np.zeros((1, 112, 112), np.uint16)
    np.testing.assert_array_equal(native.rgb565_to_int8(frames),
                                  np.asarray(jpre.rgb565_to_int8_input(
                                      frames)))
