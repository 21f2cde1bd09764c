"""The port's int8 operators against ``yoloface_tpu.ops.int8_fast*`` and the
exact ``yoloface_tpu.ops.int8_ref`` operators, bit for bit (tolerance 0):
convs at strides 1 and 2, SAME and VALID, odd widths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.core.fixedpoint import (quantize_multiplier,
                                          quantize_multiplier_arr)
from yoloface_tpu.ops import int8_fast as jfast
from yoloface_tpu.ops import int8_fast2 as jfast2
from yoloface_tpu.ops import int8_ref as jref
from yoloface_tpu_torch.ops import int8_fast as tfast
from yoloface_tpu_torch.ops import int8_fast2 as tfast2
from yoloface_tpu_torch.ops import int8_ref as tref

torch.set_num_threads(1)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int64).astype(np.int8)


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _conv_case(rng, kh, ci, co, depthwise):
    w = _i8(rng, (1, kh, kh, ci) if depthwise else (co, kh, kh, ci))
    bias = rng.integers(-6000, 6000, co if not depthwise else ci,
                        dtype=np.int64).astype(np.int32)
    n_out = ci if depthwise else co
    scale = rng.uniform(2e-4, 4e-3, n_out).astype(np.float32)
    return w, bias, scale


# (kernel, stride, padding, H, W, Ci, Co)
CONVS = [(1, 1, "SAME", 7, 9, 5, 6), (3, 1, "SAME", 9, 7, 3, 8),
         (3, 2, "SAME", 9, 11, 4, 5), (3, 2, "VALID", 11, 9, 3, 4),
         (5, 1, "VALID", 8, 13, 2, 3)]


@pytest.mark.parametrize("kh,stride,padding,h,w,ci,co", CONVS)
def test_conv2d_fast(kh, stride, padding, h, w, ci, co):
    rng = np.random.default_rng(kh * 100 + stride * 10 + w)
    x = _i8(rng, (2, h, w, ci))
    wt, b, s = _conv_case(rng, kh, ci, co, False)
    kw = dict(input_zp=-7, output_zp=5, stride=(stride, stride),
              padding=padding)
    _eq(jfast.conv2d_int8_fast(jnp.asarray(x), wt, b, scale=s, **kw),
        tfast.conv2d_int8_fast(torch.from_numpy(x), torch.from_numpy(wt),
                               torch.from_numpy(b),
                               scale=torch.from_numpy(s), **kw))


@pytest.mark.parametrize("kh,stride,padding,w",
                         [(3, 1, "SAME", 9), (3, 2, "SAME", 11),
                          (3, 2, "VALID", 13), (5, 1, "SAME", 7)])
def test_depthwise_fast(kh, stride, padding, w):
    rng = np.random.default_rng(kh + stride + w)
    x = _i8(rng, (2, 9, w, 6))
    wt, b, s = _conv_case(rng, kh, 6, 6, True)
    kw = dict(input_zp=3, output_zp=-11, stride=(stride, stride),
              padding=padding)
    _eq(jfast.depthwise_conv2d_int8_fast(jnp.asarray(x), wt, b, scale=s, **kw),
        tfast.depthwise_conv2d_int8_fast(
            torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
            scale=torch.from_numpy(s), **kw))


@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("stride,padding,w", [(1, "SAME", 9), (2, "VALID", 11),
                                              (2, "SAME", 7)])
def test_conv_leaky_fast2(depthwise, stride, padding, w):
    rng = np.random.default_rng(stride * 7 + w + depthwise)
    x = _i8(rng, (3, 9, w, 4))
    wt, b, s = _conv_case(rng, 3, 4, 5, depthwise)
    kw = dict(input_zp=-128, conv_zp=4, out_zp=-20,
              s_id=float(np.float32(0.83)), s_al=float(np.float32(0.083)),
              stride=(stride, stride), padding=padding)
    jf = (jfast2.depthwise_conv2d_leaky_int8_fast2 if depthwise
          else jfast2.conv2d_leaky_int8_fast2)
    tf = (tfast2.depthwise_conv2d_leaky_int8_fast2 if depthwise
          else tfast2.conv2d_leaky_int8_fast2)
    _eq(jf(jnp.asarray(x), wt, b, scale=s, **kw),
        tf(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
           scale=torch.from_numpy(s), **kw))


def test_leaky_add_requantize_fast():
    rng = np.random.default_rng(3)
    a, b = _i8(rng, (4, 5, 7, 6)), _i8(rng, (4, 5, 7, 6))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    s1, s2, s3 = (np.float32(v) for v in (0.8173, 0.0817, 1.3191))
    kw = dict(input_zp=9, output_zp=-3, scale_identity=s1, scale_alpha=s2)
    _eq(jfast.leaky_relu_int8_fast(jnp.asarray(a), **kw),
        tfast.leaky_relu_int8_fast(ta, **kw))
    kw = dict(zp1=-5, zp2=12, zp_out=2, scale1=s1, scale2=s3)
    _eq(jfast.add_int8_fast(jnp.asarray(a), jnp.asarray(b), **kw),
        tfast.add_int8_fast(ta, tb, **kw))
    kw = dict(input_zp=-20, output_zp=7, scale=s3)
    _eq(jfast.requantize_int8_fast(jnp.asarray(a), **kw),
        tfast.requantize_int8_fast(ta, **kw))


@pytest.mark.parametrize("filt,stride,padding,w", [
    (2, 2, "SAME", 7), (8, 2, "SAME", 12), (2, 1, "SAME", 5),
    (3, 2, "VALID", 9)])
def test_maxpool(filt, stride, padding, w):
    x = _i8(np.random.default_rng(filt + w), (2, 9, w, 3))
    kw = dict(filter_hw=(filt, filt), stride=(stride, stride),
              padding=padding)
    _eq(jref.maxpool_int8(jnp.asarray(x), **kw),
        tref.maxpool_int8(torch.from_numpy(x), **kw))


def test_pad_and_concat():
    rng = np.random.default_rng(5)
    a, b = _i8(rng, (2, 5, 7, 3)), _i8(rng, (2, 5, 7, 4))
    pads = np.array([[0, 0], [1, 0], [0, 1], [0, 0]])
    _eq(jref.pad_int8(jnp.asarray(a), pads, -9),
        tref.pad_int8(torch.from_numpy(a), pads, -9))
    _eq(jref.concat_int8([jnp.asarray(a), jnp.asarray(b)], 3),
        tref.concat_int8([torch.from_numpy(a), torch.from_numpy(b)], 3))


@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("kh,stride,padding,w", [(1, 1, "SAME", 7),
                                                 (3, 1, "SAME", 9),
                                                 (3, 2, "SAME", 11),
                                                 (3, 2, "VALID", 13)])
def test_conv_exact(depthwise, kh, stride, padding, w):
    rng = np.random.default_rng(kh * 10 + stride + w + 50 * depthwise)
    x = _i8(rng, (2, 9, w, 5))
    wt, b, s = _conv_case(rng, kh, 5, 6, depthwise)
    # per-channel multipliers from the real scales, as the engine derives them
    qm, shift = quantize_multiplier_arr(s.astype(np.float64))
    kw = dict(input_zp=-9, output_zp=4, stride=(stride, stride),
              padding=padding)
    jf = jref.depthwise_conv2d_int8 if depthwise else jref.conv2d_int8
    tf = tref.depthwise_conv2d_int8 if depthwise else tref.conv2d_int8
    want = jf(jnp.asarray(x), wt, b, qm=qm, shift=shift, **kw)
    _eq(want, tf(torch.from_numpy(x), torch.from_numpy(wt),
                 torch.from_numpy(b), qm=torch.from_numpy(qm),
                 shift=torch.from_numpy(shift), **kw))
    assert 0 < (np.abs(np.asarray(want)) < 127).mean()


@pytest.mark.parametrize("ratio,alpha", [(0.83, 0.1), (1.7, 0.1),
                                         (0.0313, 0.2), (3.9, 0.01)])
def test_leaky_requantize_exact(ratio, alpha):
    """Every int8 input, both branches; ratios > 1 take a left shift."""
    x = np.arange(-128, 128, dtype=np.int64).astype(np.int8)
    x = np.stack([x, x[::-1]]).reshape(2, 8, 16, 2)
    qm_id, sh_id = quantize_multiplier(ratio)
    qm_al, sh_al = quantize_multiplier(ratio * alpha)
    kw = dict(input_zp=-3, output_zp=11, qm_identity=qm_id,
              shift_identity=sh_id, qm_alpha=qm_al, shift_alpha=sh_al)
    _eq(jref.leaky_relu_int8(jnp.asarray(x), **kw),
        tref.leaky_relu_int8(torch.from_numpy(x), **kw))
    kw = dict(input_zp=17, output_zp=-6, qm=qm_id, shift=sh_id)
    _eq(jref.requantize_int8(jnp.asarray(x), **kw),
        tref.requantize_int8(torch.from_numpy(x), **kw))


@pytest.mark.parametrize("s1,s2,so", [(0.05, 0.08, 0.11), (0.2, 0.013, 0.05),
                                      (0.031, 0.031, 0.9)])
def test_add_exact(s1, s2, so):
    """The engine's exact ADD constants (left shift 20) on random tensors."""
    rng = np.random.default_rng(int(s1 * 1000))
    a, b = _i8(rng, (3, 5, 7, 4)), _i8(rng, (3, 5, 7, 4))
    twice_max = 2.0 * max(s1, s2)
    qm1, sh1 = quantize_multiplier(s1 / twice_max)
    qm2, sh2 = quantize_multiplier(s2 / twice_max)
    qmo, sho = quantize_multiplier(twice_max / ((1 << 20) * so))
    kw = dict(zp1=-5, zp2=12, zp_out=3, qm1=qm1, shift1=sh1, qm2=qm2,
              shift2=sh2, qm_out=qmo, shift_out=sho, left_shift=20)
    _eq(jref.add_int8(jnp.asarray(a), jnp.asarray(b), **kw),
        tref.add_int8(torch.from_numpy(a), torch.from_numpy(b), **kw))
