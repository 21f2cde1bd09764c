"""The port's head (the fused kernel's plain version and the staged path)
against the JAX fused head (Pallas interpret) and staged path on the
crafted tensors of test_pipeline.py: all-below-threshold frames,
saturation ties, an NMS-heavy frame.

The top-K kernel's plain version (``topk_conf_plain``) against
``pallas_head.topk_conf_int8`` in interpret mode: indices equal exactly on
every frame whose ranking keys agree bit for bit between the two (checked
by comparing the key tensors), and against the port's own stable-sort
``_top_k`` on its own key everywhere.

Tolerance: validity is exact; boxes within ``BOX_ATOL`` and scores within
``SCORE_ATOL`` (pipeline/head.py), because torch's and XLA's CPU ``exp``
differ by one ulp on some int8 inputs.  Within the port, the fused plain
version and the staged path are bit-identical."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.kernels.pallas_head import topk_conf_int8
from yoloface_tpu.pipeline import head as jhead
from yoloface_tpu_torch.kernels.head import (detect_head, detect_head_plain,
                                             topk_conf, topk_conf_plain)
from yoloface_tpu_torch.pipeline import head as thead

torch.set_num_threads(1)
SCALE, ZP = 0.14218327403068542, -15


def _crafted(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(-128, 128, (48, 7, 7, 18), dtype=np.int64).astype(np.int8)
    y[:4] = -128                       # all-below-threshold frames
    y[5] = 127                         # saturation ties everywhere
    y[6, :, :, 4::6] = 127             # every candidate passes -> NMS-heavy
    return y


def assert_detections_close(got, want):
    (gb, gs, gv), (wb, ws, wv) = [[np.asarray(a) for a in r]
                                  for r in (got, want)]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=thead.BOX_ATOL)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=thead.SCORE_ATOL)


def _staged(cfg):
    return dataclasses.replace(cfg, use_fused_head=False,
                               use_pallas_topk=False)


@pytest.fixture(scope="module")
def jax_fused():
    """JAX's fused head in interpret mode, once (it takes seconds)."""
    y = _crafted(23)
    return y, jhead.detect_int8_head(y, scale=SCALE, zero_point=ZP,
                                     cfg=jhead.HeadConfig())


def test_fused_plain_equals_jax_fused_kernel(jax_fused):
    y, want = jax_fused
    got = detect_head(torch.from_numpy(y), scale=SCALE, zero_point=ZP)
    assert_detections_close(got, want)
    assert np.asarray(want[2])[:4].sum() == 0 and got[2][6].sum() >= 1


@pytest.mark.parametrize("seed", [17, 23])
@pytest.mark.parametrize("nms", [True, False])
def test_staged_equals_jax_staged(seed, nms):
    y = _crafted(seed)
    jcfg = _staged(jhead.HeadConfig(apply_nms=nms))
    tcfg = _staged(thead.HeadConfig(apply_nms=nms))
    want = jhead.detect_int8_head(y, scale=SCALE, zero_point=ZP, cfg=jcfg)
    got = thead.detect_int8_head(torch.from_numpy(y), scale=SCALE,
                                 zero_point=ZP, cfg=tcfg)
    assert_detections_close(got, want)


@pytest.mark.parametrize("nms", [True, False])
def test_fused_plain_equals_staged_bit_for_bit(nms):
    y = torch.from_numpy(_crafted(23))
    cfg = thead.HeadConfig(apply_nms=nms)
    a = detect_head_plain(y, scale=SCALE, zero_point=ZP, cfg=cfg)
    b = thead.detect_int8_head(y, scale=SCALE, zero_point=ZP,
                               cfg=_staged(cfg))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_decode_and_select_equal_jax():
    rng = np.random.default_rng(9)
    y = rng.integers(-128, 128, (6, 7, 7, 18), dtype=np.int64).astype(np.int8)
    jb, jc, jk = (np.asarray(a) for a in
                  jhead.decode(y, scale=SCALE, zero_point=ZP))
    tb, tc, tk = thead.decode(torch.from_numpy(y), scale=SCALE, zero_point=ZP)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-6, atol=thead.BOX_ATOL)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=thead.SCORE_ATOL)
    np.testing.assert_allclose(tk.numpy(), jk, rtol=0, atol=thead.SCORE_ATOL)
    cfg = thead.HeadConfig(conf_threshold=0.3)
    want = jhead.select_detections(
        np.asarray(jhead.clamp_boxes(jb)), jc,
        jhead.HeadConfig(conf_threshold=0.3))
    got = thead.select_detections(
        thead.clamp_boxes(torch.from_numpy(np.array(jb))),
        torch.from_numpy(np.array(jc)), cfg)
    for u, v in zip(got, want):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))


def _jax_key(y):
    """The JAX kernels' ranking key [N,147] in (anchor,row,col) order."""
    q = jnp.asarray(y[..., 4::6].astype(np.float32))          # [N,7,7,3]
    conf = 1.0 / (1.0 + jnp.exp(-((q - float(ZP)) * float(SCALE))))
    key = jnp.where(conf >= 0.7, conf, 0.0)
    return np.asarray(jnp.transpose(key, (0, 3, 1, 2))).reshape(len(y), -1)


def _agreeing_frames(seed):
    """Frames whose confidence channels take only int8 values on which the
    JAX and torch keys agree bit for bit, half of them saturating to 1.0
    (ties everywhere)."""
    y = np.zeros((2, 7, 7, 18), np.int8)
    y[..., 4::6] = np.resize(np.arange(-128, 128), (2, 7, 7, 3))
    _, tkey = thead.rank_key(torch.from_numpy(y), scale=SCALE, zero_point=ZP)
    q = y[..., 4::6].transpose(0, 3, 1, 2).reshape(2, -1)   # key order
    ok = np.setdiff1d(q, q[_jax_key(y) != tkey.numpy()]).astype(np.int8)
    assert ok.size > 200
    rng = np.random.default_rng(seed)
    y = _crafted(seed)
    y[..., 4::6] = rng.choice(ok, y[..., 4::6].shape)
    y[8:16, ..., 4::6] = rng.choice(ok[ok > 100], y[8:16, ..., 4::6].shape)
    return y


@pytest.mark.parametrize("frames", ["crafted", "agreeing"])
def test_topk_conf_plain_equals_jax_kernel(frames):
    y = _crafted(23) if frames == "crafted" else _agreeing_frames(31)
    ty = torch.from_numpy(y)
    want = np.asarray(topk_conf_int8(y, 16, 7, 3, scale=SCALE, zero_point=ZP,
                                     conf_threshold=0.7))
    got = topk_conf_plain(ty, 16, scale=SCALE, zero_point=ZP)
    assert got.dtype == torch.int32 and got.shape == (48, 16)
    _, tkey = thead.rank_key(ty, scale=SCALE, zero_point=ZP)
    same = (_jax_key(y) == tkey.numpy()).all(-1)
    assert same.sum() >= (8 if frames == "crafted" else 48)
    np.testing.assert_array_equal(got.numpy()[same], want[same])
    # everywhere: the port's stable sort on its own key, and the wrapper
    np.testing.assert_array_equal(got.numpy(), thead._top_k(tkey, 16)[1])
    assert torch.equal(topk_conf(ty, 16, scale=SCALE, zero_point=ZP), got)


@pytest.mark.parametrize("nms", [True, False])
def test_topk_only_head_equals_jax(nms):
    """The staged head ranked by the top-K kernel (the config that raised
    before B5 was ported) against JAX's, and bit for bit against the port's
    stable-sort staged head."""
    y = _agreeing_frames(37)
    cfg = dataclasses.replace(thead.HeadConfig(apply_nms=nms),
                              use_fused_head=False)
    jcfg = dataclasses.replace(jhead.HeadConfig(apply_nms=nms),
                               use_fused_head=False)
    assert cfg.use_pallas_topk and jcfg.use_pallas_topk
    got = thead.detect_int8_head(torch.from_numpy(y), scale=SCALE,
                                 zero_point=ZP, cfg=cfg)
    assert_detections_close(got, jhead.detect_int8_head(
        y, scale=SCALE, zero_point=ZP, cfg=jcfg))
    ref = thead.detect_int8_head(torch.from_numpy(y), scale=SCALE,
                                 zero_point=ZP, cfg=_staged(cfg))
    for u, v in zip(got, ref):
        assert torch.equal(u, v)
    assert got[2].sum() > 0
