"""The head past 256 cells (grid * grid * anchors): the 448 family's grid
56 (9,408 cells) and the x2 retarget's grid 14 (588), where the head
kernels (``csrc/detect_head.cu``, ``csrc/topk_conf.cu``) take their block
path (``yf::block_topk`` in ``csrc/topk.cuh``).  The kernels themselves run
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``); here:

* the port's plain versions (``detect_head_plain``, the staged path) against
  JAX's ``detect_int8_head`` with the fused Pallas head in interpret mode,
  on the golden 448 heads (``head448``, ``head448_exact``,
  ``converted448_fast2``) at the 448 net's output qparams, a tie-heavy grid
  56 tensor and tie-heavy and random grid 14 tensors;
* ``topk_conf_plain`` against JAX ``topk_conf_int8`` at K = 1, 16 and 32,
  exactly, on frames whose ranking keys agree bit for bit;
* a numpy mirror of the block path's selection (cells counted by rank, the
  level, the index-ordered pass that stops at K, the order in one warp)
  against ``masked_argmax`` (the kernels' plain version), exactly;
* the slice: ``FacePipeline`` on ``retarget_spatial(corpus, 2)`` in
  ``tiled2`` with the default head (grid 14) against JAX's pipeline on the
  same seeded frames, and the CLI's ``detect.load(..., retarget=2)``.

Tolerance: validity and indices exact; boxes within 8 float32 ulps of the
frame's largest coordinate (grid * stride - 1: 3.05e-5 px at 56 px,
6.1e-5 at 112, 2.44e-4 at 448, ``chip_smoke.BOX_ATOL448``) and scores
within ``SCORE_ATOL``, because torch's and XLA's CPU ``exp`` differ by one
ulp on some int8 inputs.  Within the port, the fused plain version and the
staged path are bit-identical."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.graph.retarget import retarget_spatial as jax_retarget
from yoloface_tpu.io.tflite_import import load_tflite as jax_load_tflite
from yoloface_tpu.kernels.pallas_head import topk_conf_int8
from yoloface_tpu.pipeline import head as jhead
from yoloface_tpu.pipeline.e2e import FacePipeline as JaxPipeline
from yoloface_tpu.runtime.engine import Int8Engine as JaxEngine
from yoloface_tpu_torch import detect
from yoloface_tpu_torch.graph.retarget import retarget_spatial
from yoloface_tpu_torch.io.tflite_import import load_tflite
from yoloface_tpu_torch.kernels.head import (MAX_KEYS, WARP_KEYS, detect_head,
                                             detect_head_plain,
                                             masked_argmax, topk_conf,
                                             topk_conf_plain)
from yoloface_tpu_torch.pipeline import head as thead
from yoloface_tpu_torch.pipeline.e2e import FacePipeline
from yoloface_tpu_torch.runtime.engine import Int8Engine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "checkpoints", "yoloface_corpus_int8.tflite")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_frames.npz")
SCALE448, ZP448 = 0.1631404161453247, 7     # the 448 net's output qparams
BLOCK_THREADS = 256                         # csrc/topk.cuh kBlockThreads


def _golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden",
        os.path.join(REPO, "tools", "make_torch_port_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = _golden_tool()


def box_atol(grid: int, stride: int = 8) -> float:
    """8 float32 ulps of the frame's largest coordinate."""
    return 8 * float(np.spacing(np.float32(grid * stride - 1)))


def assert_detections_close(got, want, grid):
    (gb, gs, gv), (wb, ws, wv) = [[np.asarray(a) for a in r]
                                  for r in (got, want)]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=box_atol(grid))
    np.testing.assert_allclose(gs, ws, rtol=0, atol=thead.SCORE_ATOL)


def _heads(name):
    """int8 heads [N,g,g,18] and their (scale, zero point)."""
    if name in ("head448", "head448_exact", "converted448_fast2"):
        return np.load(GOLDEN)[name], (SCALE448, ZP448)
    if name == "tie-heavy 56":
        return TOOL.tie_heavy_heads(8, grid=56), (SCALE448, ZP448)
    if name == "tie-heavy 14":
        return TOOL.tie_heavy_heads(16, grid=14), (SCALE448, ZP448)
    g, a = {"random 14": (14, 3), "random 17, 1 anchor": (17, 1),
            "random 9, 4 anchors": (9, 4)}[name]
    rng = np.random.default_rng(g)
    y = rng.integers(-128, 128, (12, g, g, 6 * a), dtype=np.int64)
    y[0, ..., 4::6] = 127                              # every cell passes
    return y.astype(np.int8), (SCALE448, ZP448)


ANCHORS4 = ((9.0, 14.0), (12.0, 17.0), (22.0, 21.0), (30.0, 35.0))


HEADS = ["head448", "head448_exact", "converted448_fast2", "tie-heavy 56",
         "tie-heavy 14", "random 14"]


@pytest.fixture(scope="module")
def jax_fused():
    """JAX's fused head (Pallas interpret) on each head set, NMS on, once
    (2-4 s a call at grid 56)."""
    out = {}
    for name in HEADS:
        y, (scale, zp) = _heads(name)
        cfg = jhead.HeadConfig(grid=y.shape[1])
        out[name] = jhead.detect_int8_head(y, scale=scale, zero_point=zp,
                                           cfg=cfg)
    return out


def _staged(cfg, pallas_topk=False):
    return dataclasses.replace(cfg, use_fused_head=False,
                               use_pallas_topk=pallas_topk)


@pytest.mark.parametrize("name", HEADS)
def test_fused_plain_equals_jax_fused_kernel(jax_fused, name):
    y, (scale, zp) = _heads(name)
    cfg = thead.HeadConfig(grid=y.shape[1])
    assert cfg.num_cells > WARP_KEYS
    got = detect_head_plain(torch.from_numpy(y), scale=scale, zero_point=zp,
                            cfg=cfg)
    assert_detections_close(got, jax_fused[name], y.shape[1])
    if name.startswith("tie-heavy"):       # saturated frames detect
        assert got[2][0].sum() >= 1 and got[2][len(y) // 2 - 1].sum() == 0


@pytest.mark.parametrize("name", HEADS)
@pytest.mark.parametrize("nms", [True, False])
def test_fused_plain_equals_staged_bit_for_bit(name, nms):
    """The fused plain version, the staged head by a stable sort and the
    staged head by the top-K wrapper (its plain version on the CPU): equal
    bit for bit."""
    y, (scale, zp) = _heads(name)
    ty = torch.from_numpy(y)
    cfg = thead.HeadConfig(grid=y.shape[1], apply_nms=nms)
    kw = dict(scale=scale, zero_point=zp)
    want = detect_head_plain(ty, cfg=cfg, **kw)
    for c in (cfg, _staged(cfg), _staged(cfg, pallas_topk=True)):
        for u, v in zip(thead.detect_int8_head(ty, cfg=c, **kw), want):
            assert torch.equal(u, v)
    for u, v in zip(detect_head(ty, cfg=cfg, **kw), want):  # the wrapper
        assert torch.equal(u, v)


@pytest.mark.parametrize("name", ["head448", "tie-heavy 56", "tie-heavy 14"])
def test_staged_equals_jax_staged(name):
    y, (scale, zp) = _heads(name)
    g = y.shape[1]
    want = jhead.detect_int8_head(y, scale=scale, zero_point=zp,
                                  cfg=_staged(jhead.HeadConfig(grid=g)))
    got = thead.detect_int8_head(torch.from_numpy(y), scale=scale,
                                 zero_point=zp,
                                 cfg=_staged(thead.HeadConfig(grid=g)))
    assert_detections_close(got, want, g)


def _jax_key(y, scale, zp):
    """The JAX kernels' ranking key [N,C] in (anchor,row,col) order."""
    q = jnp.asarray(y[..., 4::6].astype(np.float32))
    conf = 1.0 / (1.0 + jnp.exp(-((q - float(zp)) * float(scale))))
    key = jnp.where(conf >= 0.7, conf, 0.0)
    return np.asarray(jnp.transpose(key, (0, 3, 1, 2))).reshape(len(y), -1)


def _agreeing_frames(seed, n, grid, scale, zp):
    """Frames whose confidences take only int8 values on which the JAX and
    torch keys agree bit for bit (``test_torch_head._agreeing_frames``'s
    rule), a quarter of them on values that saturate the sigmoid (ties
    everywhere) and a quarter below the threshold."""
    levels = np.zeros((1, 16, 16, 18), np.int8)
    levels[..., 4::6] = np.arange(-128, 128).reshape(1, 16, 16, 1)
    _, tkey = thead.rank_key(torch.from_numpy(levels), scale=scale,
                             zero_point=zp, cfg=thead.HeadConfig(grid=16))
    q = levels[..., 4::6].transpose(0, 3, 1, 2).reshape(-1)
    bad = q[_jax_key(levels, scale, zp)[0] != tkey.numpy()[0]]
    ok = np.setdiff1d(np.arange(-128, 128), bad).astype(np.int8)
    assert ok.size > 200
    key_of = dict(zip(q.tolist(), tkey.numpy()[0].tolist()))
    high = ok[np.array([key_of[int(v)] == 1.0 for v in ok])]
    low = ok[np.array([key_of[int(v)] == 0.0 for v in ok])]
    assert high.size >= 2 and low.size >= 2
    rng = np.random.default_rng(seed)
    y = rng.integers(-128, 128, (n, grid, grid, 18), dtype=np.int64)
    y = y.astype(np.int8)
    y[..., 4::6] = rng.choice(ok, y[..., 4::6].shape)
    y[: n // 4, ..., 4::6] = rng.choice(high, y[: n // 4, ..., 4::6].shape)
    y[n // 4: n // 2, ..., 4::6] = rng.choice(
        low, y[n // 4: n // 2, ..., 4::6].shape)
    return y


@pytest.mark.parametrize("grid", [14, 56])
def test_topk_conf_plain_equals_jax_kernel(grid):
    n = 8
    y = _agreeing_frames(41 + grid, n, grid, SCALE448, ZP448)
    ty = torch.from_numpy(y)
    _, tkey = thead.rank_key(ty, scale=SCALE448, zero_point=ZP448,
                             cfg=thead.HeadConfig(grid=grid))
    assert (_jax_key(y, SCALE448, ZP448) == tkey.numpy()).all()
    cfg = thead.HeadConfig(grid=grid)
    for k in (1, 16, 32):
        want = np.asarray(topk_conf_int8(y, k, grid, 3, scale=SCALE448,
                                         zero_point=ZP448,
                                         conf_threshold=0.7))
        got = topk_conf_plain(ty, k, scale=SCALE448, zero_point=ZP448,
                              cfg=cfg)
        assert got.dtype == torch.int32 and got.shape == (n, k)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(topk_conf(ty, k, scale=SCALE448, zero_point=ZP448,
                                     cfg=cfg), got)


# ---------------------------------------------------- the block path mirror
def _rank_table(scale, zp, thr=0.7):
    """rank + 1 of each int8 confidence at q + 128, as ``yf::
    build_rank_table`` gives it: the count of levels with a smaller key,
    plus one (the run-start form gives the same values where no key
    falls)."""
    levels = np.zeros((1, 16, 16, 18), np.int8)
    levels[..., 4::6] = np.arange(-128, 128).reshape(1, 16, 16, 1)
    _, key = thead.rank_key(torch.from_numpy(levels), scale=scale,
                            zero_point=zp,
                            cfg=thead.HeadConfig(grid=16,
                                                 conf_threshold=thr))
    key = key.numpy()[0, :256]
    return (key[None, :] < key[:, None]).sum(1) + 1


def block_topk_mirror(y, k, scale, zp, thr=0.7):
    """``yf::block_topk`` for int8 heads [N,g,g,a*6] -> (int32 [N,K]
    indices, chunks of the ordered pass each frame read)."""
    n, g = y.shape[:2]
    a, cells = y.shape[3] // 6, g * g
    r1 = _rank_table(scale, zp, thr)[
        y[..., 4::6].astype(np.int64) + 128]                   # [N,g,g,a]
    r1 = r1.transpose(0, 3, 1, 2).reshape(n, a, cells)       # flat order
    out = np.empty((n, k), np.int32)
    chunks = np.empty(n, np.int64)
    for i in range(n):
        count = np.bincount(r1[i].ravel() - 1, minlength=256)
        above = np.concatenate([np.cumsum(count[::-1])[::-1][1:], [0]])
        j = np.flatnonzero((above < k) & (above + count >= k))
        assert j.size == 1
        level, need = j[0] + 1, k - above[j[0]]
        cand, at_before, read = [], 0, 0
        for an in range(a):
            for base in range(0, cells, BLOCK_THREADS):
                rk = r1[i, an, base:base + BLOCK_THREADS]
                f = an * cells + base + np.arange(rk.size)
                at = rk == level
                before = at_before + np.cumsum(at) - at
                take = (rk > level) | (at & (before < need))
                cand += list((rk[take].astype(np.uint64) << np.uint64(23))
                             | (np.uint64(0x7FFFFF) - f[take].astype(
                                 np.uint64)))
                at_before += int(at.sum())
                read += 1
                if len(cand) == k:
                    break
            if len(cand) == k:
                break
        assert len(cand) == k
        order = sorted(cand, reverse=True)           # K rounds of a max
        out[i] = [0x7FFFFF - int(c & 0x7FFFFF) for c in order]
        chunks[i] = read
    return out, chunks


@pytest.mark.parametrize("scale", [SCALE448, -SCALE448])
@pytest.mark.parametrize("name", ["tie-heavy 56", "tie-heavy 14",
                                  "head448", "random 14",
                                  "random 17, 1 anchor",
                                  "random 9, 4 anchors"])
def test_block_topk_mirror_equals_masked_argmax(name, scale):
    """The block path's selection gives ``masked_argmax``'s indices on the
    plain version's keys, K = 1, 16 and 32; with a negative scale the keys
    fall as the confidence grows (the rank table's counting form).  On
    frames with fewer than K keys above the threshold the ordered pass
    stops in its first chunk."""
    y, (_, zp) = _heads(name)
    g = y.shape[1]
    # the packing's limit: rank + 1 in 9 bits, the index in the other 23
    assert MAX_KEYS == 0x7FFFFF and (256 << 23) | 0x7FFFFF < 2 ** 32
    cfg = thead.HeadConfig(grid=g, anchors=ANCHORS4[:y.shape[3] // 6])
    assert cfg.num_cells > WARP_KEYS
    _, key = thead.rank_key(torch.from_numpy(y), scale=scale, zero_point=zp,
                            cfg=cfg)
    for k in (1, 16, 32):
        got, chunks = block_topk_mirror(y, k, scale, zp)
        np.testing.assert_array_equal(got, masked_argmax(key, k).numpy())
        if name.startswith("tie-heavy"):   # saturated, then all-zero frames
            assert chunks[0] == 1 and chunks[len(y) // 2 - 1] == 1


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def frames112():
    rng = np.random.default_rng(112)
    x = rng.integers(-128, 128, (3, 112, 112, 3), dtype=np.int64)
    x[0] //= 4                                    # a quieter frame
    return x.astype(np.int8)


def test_retarget2_pipeline_equals_jax(frames112):
    """``FacePipeline`` on the x2 retarget in ``tiled2`` on the CPU with
    the default head (grid 14, the fused head) against JAX's pipeline on
    the same frames (JAX ``fast2``, the bits ``pallas_tiled2`` gives, and
    its fused Pallas head in interpret mode)."""
    jg = jax_retarget(jax_load_tflite(CORPUS), 2)
    g = retarget_spatial(load_tflite(CORPUS), 2)
    cfg = thead.HeadConfig(grid=14)
    assert cfg.use_fused_head and cfg.num_cells == 588
    want = JaxPipeline(JaxEngine(jg, mode="fast2"),
                       jhead.HeadConfig(grid=14)).detect_int8(frames112)
    got = FacePipeline(Int8Engine(g, "tiled2", device="cpu"),
                       cfg).detect_int8(frames112)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["count"], want["count"])
    assert_detections_close((got["boxes"], got["scores"], got["valid"]),
                            (want["boxes"], want["scores"], want["valid"]),
                            14)


def test_detect_load_retarget_serves_grid_14(frames112):
    """The CLI's ``detect.load(..., retarget=2)``: the default fused head
    at grid 14, equal to the pipeline above bit for bit."""
    pipe = detect.load(CORPUS, "tiled2", "cpu", retarget=2)
    assert pipe.head_config.grid == 14 and pipe.head_config.use_fused_head
    g = retarget_spatial(load_tflite(CORPUS), 2)
    want = FacePipeline(Int8Engine(g, "tiled2", device="cpu"),
                        thead.HeadConfig(grid=14)).detect_int8(frames112)
    got = pipe.detect_int8(frames112)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
