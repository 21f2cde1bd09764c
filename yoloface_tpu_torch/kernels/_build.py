"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources build into two shared libraries with a plain C interface (no
PyTorch headers, so a build takes seconds): ``kernels``, every
``csrc/*.cu`` but the probes', which serving and training load at first
CUDA use, and ``probes``, the ``csrc/probe_*.cu`` sources of the
``tools/`` probes' counterparts (``kernels/probes.py``), built at first
probe use, so that no serving process compiles them.  Each source
compiles in its own ``nvcc`` process, all of a library's started
together, and the objects link into the library, which lands in
``build/yoloface_tpu_torch/`` at the root of the checkout, named by a
hash of its own sources (the ``.cu`` files and the headers they include).
Processes that start at once (the ranks of a mesh) build a library once:
the build holds an exclusive ``fcntl`` lock on a file beside the library,
and a process that waits for it finds the library built; each build also
writes its objects and library under names of its own process and
renames the library into place, so a reader never sees half a file.
``-fmad=false`` keeps every float multiply and add separately rounded, as
the JAX twins compute them; there is no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "yoloface_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
KERNELS, PROBES = "kernels", "probes"        # the two libraries
# the probes' sources are csrc/probe_*.cu, their C entries yf_probe_*
PROBE_PREFIX, PROBE_ENTRY = "probe_", "yf_probe_"
# every C entry of both libraries: (name, argument types), each returning
# the launch's cudaGetLastError() (or a check's error), 0 for success;
# signatures(name) gives a library's own
SIGNATURES = {
    # (frames u16, out i8, n, stream)
    "yf_preprocess_rgb565": [_P, _P, _I, _P],
    # (descs, n_ops, consts, host ptr table, n_globals, n_frames,
    #  smem_bytes, scratch_off, threads, exact instantiation, op_cycles
    #  (u64 [n_ops]: the traced instantiation; null: the untraced one),
    #  stream)
    "yf_arena_stage": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # (descs, n_ops, consts, host ptr table, n_globals, n_frames, strips,
    #  smem_bytes, scratch_off, threads, exact instantiation, k32
    #  instantiation, op_cycles as above, stream)
    "yf_tiled_section": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P],
    # (exact, k32, traced, threads, dynamic shared bytes, int out[4]:
    #  registers, local bytes, static shared bytes, blocks an SM)
    "yf_tiled_section_attrs": [_I, _I, _I, _I, _I, _P],
    # (descs, n_ops, consts, host ptr table, n_globals, n_frames,
    #  smem_bytes, scratch_off, threads, exact instantiation, stream)
    "yf_fused_stage": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (exact instantiation, [traced,] threads, dynamic shared bytes, int
    #  out[4]: registers, local bytes, static shared bytes, blocks an SM)
    "yf_arena_stage_attrs": [_I, _I, _I, _I, _P],
    "yf_fused_stage_attrs": [_I, _I, _I, _P],
    # (descriptor, x, y, bytes, stream)
    "yf_eltwise_lut": [_P, _P, _P, _L, _P],
    # (descriptor, a, b, y, bytes of each, stream)
    "yf_add_int8": [_P, _P, _P, _P, _L, _P],
    # (x, y, input rows N*H, W, C, kh, kw, stream)
    "yf_resize_nearest": [_P, _P, _L, _I, _I, _I, _I, _P],
    # (host input pointers[n], host channels[n], n, y, pixels N*H*W,
    #  channel offset of the slice in y, channels of y, stream)
    "yf_concat_channels": [_P, _P, _I, _P, _L, _I, _I, _P],
    # (x, y, N, H, W, C, pt, pb, pl, pr, fill, stream)
    "yf_pad_int8": [_P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # (y, boxes, scores, valid, n, g, a, k, scale, zp, thr, iou_thr,
    #  stride, box_limit, apply_nms, host anchors[8], stream)
    "yf_detect_head": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                       _F, _I, _P, _P],
    # (y, idx i32 [n,k], n, g, a, k, scale, zp, thr, stream)
    "yf_topk_conf": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    # the tools/ probes (kernels/probes.py): pointers, host int params,
    # stream.  (src, dst, params, stream)
    "yf_probe_copy": [_P, _P, _P, _P],
    # (x, taps, scale, out, params, stream)
    "yf_probe_dw": [_P, _P, _P, _P, _P, _P],
    # (a, w, out, params, stream)
    "yf_probe_conv": [_P, _P, _P, _P, _P],
    # (x, taps, scale, out, params, stream)
    "yf_probe_dw_frames": [_P, _P, _P, _P, _P, _P],
    # (stride, offs, epi, dynamic shared bytes, int out[4]: registers,
    #  local bytes, static shared bytes, blocks an SM)
    "yf_probe_dw_frames_attrs": [_I, _I, _I, _I, _P],
    # (x, w, out, params, stream)
    "yf_probe_fi_mma": [_P, _P, _P, _P, _P],
    # (n-tiles, 8-byte accesses, int out[4] as above)
    "yf_probe_fi_mma_attrs": [_I, _I, _P],
    # (x, w, out, params, stream)
    "yf_probe_nhwc_mma": [_P, _P, _P, _P, _P],
    # (n-tiles, k chunks, any K and Nout, dynamic shared bytes, int out[4]
    #  as above)
    "yf_probe_nhwc_mma_attrs": [_I, _I, _I, _I, _P],
    # (x, taps, out, params, stream)
    "yf_probe_dw_fi_mma": [_P, _P, _P, _P, _P],
    # (int16 out, 8-byte accesses, int out[4] as above)
    "yf_probe_dw_fi_mma_attrs": [_I, _I, _P],
}

_lock = threading.Lock()
_libs = {}                    # library name -> the loaded ctypes.CDLL
build_seconds = {}            # library name -> wall time of the build this
                              # process made


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _library_name(name: str) -> str:
    if name not in (KERNELS, PROBES):
        raise ValueError(f"no kernel library {name!r}; one of "
                         f"{(KERNELS, PROBES)}")
    return name


def sources(name: str = KERNELS):
    """The ``.cu`` files library ``name`` compiles."""
    probes = _library_name(name) == PROBES
    return [p for p in sorted(CSRC.glob("*.cu"))
            if p.name.startswith(PROBE_PREFIX) == probes]


def signatures(name: str = KERNELS) -> dict:
    """The C entries library ``name`` binds: ``SIGNATURES``' ``yf_probe_*``
    for ``PROBES``, the rest for ``KERNELS``."""
    probes = _library_name(name) == PROBES
    return {fn: args for fn, args in SIGNATURES.items()
            if fn.startswith(PROBE_ENTRY) == probes}


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _headers(cus):
    """The ``csrc`` headers the sources include, directly or through
    another header."""
    seen, todo = set(), list(cus)
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            h = CSRC / inc
            if h not in seen and h.exists():
                seen.add(h)
                todo.append(h)
    return sorted(seen)


def _finish(cmd, out: str, err: str, returncode: int) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}"
                           f"\n{out}\n{err}")


def build(name: str = KERNELS) -> Path:
    """Compile library ``name`` unless one for its sources exists."""
    cus = sources(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + _headers(cus):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libyoloface_{name}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one build across processes
        if not lib.exists():
            build_seconds[name] = _compile(cus, h, lib)
    return lib


def _compile(cus, h, lib: Path) -> float:
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{cu.stem}.{tag}.o" for cu in cus]
    jobs = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(cu)]
            for cu, o in zip(cus, objs)]
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
            for cmd in jobs]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc in jobs:
            _finish(cmd, *proc.communicate(), proc.returncode)
        res = subprocess.run(link, capture_output=True, text=True)
        _finish(link, res.stdout, res.stderr, res.returncode)
    finally:
        for _, proc in jobs:            # after a failure: stop the others
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def library(name: str = KERNELS) -> ctypes.CDLL:
    """Library ``name`` (``KERNELS`` or ``PROBES``), loaded and its C
    entries typed (built on first call)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures(name).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def loaded():
    """The names of the libraries this process has loaded."""
    return set(_libs)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
