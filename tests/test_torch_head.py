"""The port's head (the fused kernel's plain version and the staged path)
against the JAX fused head (Pallas interpret) and staged path on the
crafted tensors of test_pipeline.py: all-below-threshold frames,
saturation ties, an NMS-heavy frame.

Tolerance: validity is exact; boxes within ``BOX_ATOL`` and scores within
``SCORE_ATOL`` (pipeline/head.py), because torch's and XLA's CPU ``exp``
differ by one ulp on some int8 inputs.  Within the port, the fused plain
version and the staged path are bit-identical."""

import dataclasses

import numpy as np
import pytest
import torch

from yoloface_tpu.pipeline import head as jhead
from yoloface_tpu_torch.kernels.head import detect_head, detect_head_plain
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


def test_topk_only_head_is_not_ported_yet():
    cfg = thead.HeadConfig(use_pallas_topk=True, use_fused_head=False)
    with pytest.raises(NotImplementedError, match="B5"):
        thead.detect_int8_head(torch.zeros((1, 7, 7, 18), dtype=torch.int8),
                               scale=SCALE, zero_point=ZP, cfg=cfg)
