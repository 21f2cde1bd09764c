"""ctypes binding for the native frame pipeline (native/framepipe.cpp).

The counterpart of ``yoloface_tpu.host.native``.  The library is built on
first use with ``g++`` from the repository's ``native/framepipe.cpp`` into
``build/yoloface_tpu_torch/`` (git-ignored), named by a hash of the source
and the flags; the tracked ``native/libframepipe.so`` is never read or
written.  It exposes the C++ preprocess, RGB565 encode, ring buffer,
multi-stream scheduler and protocol encoder; every entry point has a
pure-Python fallback (``pipeline/preprocess.py``, ``host/protocol.py``)
used when no compiler builds the library, as in the JAX package.  Bit
parity between the two is held by tests/test_torch_native.py.

``NativeRing.pop`` and ``NativeScheduler.next_batch`` take an optional
``out=`` buffer (a contiguous numpy array or CPU tensor, pinned for a
copy to the card) and fill it in place, so a batch goes from the ring
straight into the buffer the card copies from; without ``out=`` they
return what the JAX package's return.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from yoloface_tpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "framepipe.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None   # why the last build failed, if it did

_U8P = ctypes.POINTER(ctypes.c_uint8)


def build() -> Path:
    """Compile ``SOURCE`` unless a library of this source and these flags
    exists; -> its path under ``BUILD_DIR``."""
    cxx = os.environ.get("CXX", "g++")
    if not shutil.which(cxx):
        raise RuntimeError(f"no C++ compiler ({cxx})")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libframepipe_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable
    (``build_error`` says why)."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        lib.fp_rgb565_to_int8.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int8)]
        lib.fp_rgb565_to_int8.restype = None
        lib.fp_encode_rgb565.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16)]
        lib.fp_encode_rgb565.restype = None
        lib.fp_ring_create.restype = ctypes.c_void_p
        lib.fp_ring_create.argtypes = [ctypes.c_int, ctypes.c_size_t]
        lib.fp_ring_push.restype = ctypes.c_int
        lib.fp_ring_push.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_size_t]
        lib.fp_ring_pop.restype = ctypes.c_long
        lib.fp_ring_pop.argtypes = [ctypes.c_void_p, _U8P]
        lib.fp_ring_size.restype = ctypes.c_int
        lib.fp_ring_size.argtypes = [ctypes.c_void_p]
        lib.fp_ring_close.argtypes = [ctypes.c_void_p]
        lib.fp_ring_close.restype = None
        lib.fp_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.fp_ring_destroy.restype = None
        lib.fp_encode_frame.restype = ctypes.c_int
        lib.fp_encode_frame.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), _U8P, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.fp_sched_create.restype = ctypes.c_void_p
        lib.fp_sched_create.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                        ctypes.c_int, ctypes.c_int]
        lib.fp_sched_push.restype = ctypes.c_int
        lib.fp_sched_push.argtypes = [ctypes.c_void_p, ctypes.c_int, _U8P]
        lib.fp_sched_next_batch.restype = ctypes.c_int
        lib.fp_sched_next_batch.argtypes = [
            ctypes.c_void_p, _U8P, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64)]
        lib.fp_sched_pending.restype = ctypes.c_int
        lib.fp_sched_pending.argtypes = [ctypes.c_void_p]
        lib.fp_sched_close.argtypes = [ctypes.c_void_p]
        lib.fp_sched_close.restype = None
        lib.fp_sched_destroy.argtypes = [ctypes.c_void_p]
        lib.fp_sched_destroy.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _writable(out, nbytes: int):
    """``out``'s first byte as a ``uint8*`` for the library to fill, after
    checking it is a contiguous, writable host buffer of ``nbytes`` or
    more (a numpy array or a CPU tensor, pinned or not)."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("out must be a contiguous CPU tensor")
        have, ptr = out.numel() * out.element_size(), out.data_ptr()
    else:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("out must be a contiguous writable array")
        have, ptr = out.nbytes, out.ctypes.data
    if have < nbytes:
        raise ValueError(f"out holds {have} B, needs {nbytes}")
    return ctypes.cast(ptr, _U8P)


# ---------------------------------------------------------------- wrappers
def rgb565_to_int8(frames: np.ndarray) -> np.ndarray:
    """[N,112,112] uint16 -> [N,56,56,3] int8 via C++; Python fallback."""
    lib = get_lib()
    frames = np.ascontiguousarray(frames, np.uint16)
    n = frames.shape[0]
    if lib is None:
        from yoloface_tpu_torch.pipeline.preprocess import \
            rgb565_to_int8_input
        return rgb565_to_int8_input(torch.from_numpy(frames)).numpy()
    out = np.empty((n, 56, 56, 3), np.int8)
    lib.fp_rgb565_to_int8(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


def encode_rgb565(rgb: np.ndarray) -> np.ndarray:
    """[N,H,W,3] uint8 -> [N,H,W] uint16 via C++; Python fallback."""
    lib = get_lib()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim == 3:
        rgb = rgb[None]
    n, h, w, _ = rgb.shape
    if lib is None:
        from yoloface_tpu_torch.pipeline.preprocess import encode_rgb565 as enc
        return enc(rgb)
    out = np.empty((n, h, w), np.uint16)
    lib.fp_encode_rgb565(
        rgb.ctypes.data_as(_U8P), n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return out


def encode_frame(frame_num: int, boxes: np.ndarray, scores: np.ndarray,
                 valid: np.ndarray, scale: int = 2) -> str:
    lib = get_lib()
    if lib is None:
        from yoloface_tpu_torch.host.protocol import encode_frame as enc
        return enc(frame_num, boxes, scores, valid, scale)
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    buf = ctypes.create_string_buffer(4096)
    n = lib.fp_encode_frame(
        frame_num, boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(_U8P), len(scores), scale, buf, 4096)
    return buf.raw[:n].decode()


class NativeRing:
    """Blocking frame-batch ring buffer backed by the C++ implementation
    (the DCMI/DMA double-buffer analogue for host->device streaming)."""

    def __init__(self, capacity: int, slot_bytes: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self._slot_bytes = slot_bytes
        self._ptr = lib.fp_ring_create(capacity, slot_bytes)

    def push(self, data: np.ndarray) -> bool:
        data = np.ascontiguousarray(data)
        rc = self._lib.fp_ring_push(self._ptr, data.ctypes.data_as(_U8P),
                                    data.nbytes)
        return rc == 0

    def pop(self, out=None):
        """The oldest slot's bytes (blocking while the ring is empty), or
        None once it is closed and drained.  With ``out`` (a contiguous
        host buffer of at least a slot's bytes) the bytes are written
        there and the count written is returned instead."""
        if out is not None:
            n = self._lib.fp_ring_pop(self._ptr,
                                      _writable(out, self._slot_bytes))
            return n or None
        buf = np.empty(self._slot_bytes, np.uint8)
        n = self._lib.fp_ring_pop(self._ptr, buf.ctypes.data_as(_U8P))
        if n == 0:
            return None
        return buf[:n].tobytes()

    def __len__(self) -> int:
        return self._lib.fp_ring_size(self._ptr)

    def close(self):
        self._lib.fp_ring_close(self._ptr)

    def __del__(self):
        try:
            self._lib.fp_ring_destroy(self._ptr)
        except AttributeError:          # __init__ raised before the ring
            pass


class NativeScheduler:
    """Multi-stream frame scheduler backed by the C++ implementation
    (native/framepipe.cpp fp_sched_*): N camera streams push frames from
    producer threads; ``next_batch`` blocks until a full batch is
    assembled (FIFO across streams) and returns the frames plus the
    (stream_id, seq) tags that demultiplex detections back per camera."""

    def __init__(self, n_streams: int, frame_shape, frame_dtype,
                 batch: int, capacity: Optional[int] = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self.n_streams = n_streams
        self.batch = batch
        self.frame_shape = tuple(frame_shape)
        self.frame_dtype = np.dtype(frame_dtype)
        self._frame_bytes = int(np.prod(self.frame_shape)
                                * self.frame_dtype.itemsize)
        cap = capacity if capacity is not None else 4 * batch
        self._ptr = lib.fp_sched_create(n_streams, self._frame_bytes,
                                        batch, cap)
        if not self._ptr:
            raise ValueError("bad scheduler parameters")

    def push(self, stream_id: int, frame: np.ndarray) -> bool:
        frame = np.ascontiguousarray(frame, self.frame_dtype)
        if frame.nbytes != self._frame_bytes:
            raise ValueError(f"frame of shape {frame.shape}, expected "
                             f"{self.frame_shape}")
        rc = self._lib.fp_sched_push(self._ptr, stream_id,
                                     frame.ctypes.data_as(_U8P))
        if rc == -2:
            raise ValueError(f"bad stream id {stream_id}")
        return rc == 0

    def next_batch(self, out=None):
        """(frames [take,*frame_shape], stream_ids [take], seqs [take]) or
        None when closed and drained.  With ``out`` (a contiguous host
        buffer of ``batch`` frames) the frames are written there and
        ``out[:take]`` is returned as the frames."""
        if out is None:
            out = np.empty((self.batch,) + self.frame_shape,
                           self.frame_dtype)
        sids = np.empty(self.batch, np.int32)
        seqs = np.empty(self.batch, np.int64)
        take = self._lib.fp_sched_next_batch(
            self._ptr, _writable(out, self.batch * self._frame_bytes),
            sids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if take == 0:
            return None
        return out[:take], sids[:take], seqs[:take]

    def pending(self) -> int:
        return self._lib.fp_sched_pending(self._ptr)

    def close(self):
        self._lib.fp_sched_close(self._ptr)

    def __del__(self):
        try:
            self._lib.fp_sched_destroy(self._ptr)
        except AttributeError:          # __init__ raised before it
            pass
