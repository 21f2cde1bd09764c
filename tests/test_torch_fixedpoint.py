"""The port's fixed-point requantization (``core/fixedpoint.py``) against
``yoloface_tpu.core.fixedpoint``, bit for bit (tolerance 0): TFLite's
``QuantizeMultiplier`` on random reals and edge values, and the int64
``MultiplyByQuantizedMultiplier`` against the JAX limb version and
``mbqm_numpy`` on random int32 inputs at every shift -31..30, inside the
domain where ``x << max(shift, 0)`` fits int32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloface_tpu.core import fixedpoint as jfp
from yoloface_tpu_torch.core import fixedpoint as tfp

torch.set_num_threads(1)

EDGES = [
    0.0, 1.0, 0.5, 0.25, 0.75, 2.0 ** -31, 2.0 ** -32, 2.0 ** -33, 1e-12,
    1.0 - 2.0 ** -33,                  # mantissa rounds to 2**31: carry
    0.5 - 2.0 ** -34,                  # the same carry one octave down
    2.0 ** -31 * (1.0 - 2.0 ** -33),   # carry into shift -30 (no underflow)
    2.0 ** -32 * (1.0 - 2.0 ** -33),   # carry lands exactly at shift -31
    2.0 ** -33 * (1.0 - 2.0 ** -33),   # carry then underflow -> (0, 0)
    2.0 ** 29, 2.0 ** 30 * 1.5, 2.0 ** 31, 2.0 ** 40,   # overflow guard
    0.1, 1.0 / 3.0, 0.0078125,
]


@pytest.mark.parametrize("case", ["edges", "random"])
def test_quantize_multiplier_equals_jax(case):
    if case == "edges":
        reals = EDGES
    else:
        rng = np.random.default_rng(11)
        reals = np.exp(rng.uniform(np.log(1e-11), np.log(1e3), 3000)).tolist()
    for r in reals:
        assert tfp.quantize_multiplier(r) == jfp.quantize_multiplier(r), r
    got = tfp.quantize_multiplier_arr(reals)
    want = jfp.quantize_multiplier_arr(reals)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if case == "edges":        # the edge list reaches every special branch
        pairs = {tfp.quantize_multiplier(r) for r in EDGES}
        assert (0, 0) in pairs and (1 << 30, -30) in pairs
        assert ((1 << 31) - 1, 30) in pairs and (1 << 30, 1) in pairs


@pytest.mark.parametrize("shifts", [range(-31, -15), range(-15, 0),
                                    range(0, 16), range(16, 31)])
def test_mbqm_equals_jax_and_numpy(shifts):
    rng = np.random.default_rng(shifts.start + 100)
    for sh in shifts:
        lim = (1 << 31) >> max(sh, 0)            # x << left fits int32
        x = rng.integers(-lim, lim, 2000, dtype=np.int64)
        x = np.concatenate([x, [0, 1, -1, lim - 1, 1 - lim, -lim]])
        qm = rng.integers(1 << 30, 1 << 31, x.size, dtype=np.int64)
        qm[:3] = [1 << 30, (1 << 31) - 1, 1 << 30]
        got = tfp.multiply_by_quantized_multiplier(
            torch.from_numpy(x), torch.from_numpy(qm), sh)
        assert got.dtype == torch.int64
        want = np.asarray(jfp.multiply_by_quantized_multiplier(
            jnp.asarray(x.astype(np.int32)), jnp.asarray(qm.astype(np.int32)),
            jnp.int32(sh)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"sh {sh}")
        q0 = int(qm[5])
        np.testing.assert_array_equal(
            tfp.multiply_by_quantized_multiplier(torch.from_numpy(x), q0,
                                                 sh).numpy(),
            jfp.mbqm_numpy(x, q0, sh), err_msg=f"numpy sh {sh}")


def test_mbqm_per_channel_and_requant():
    """Per-channel (qm, shift) broadcast on the last axis, then the int8
    clip of ``requant_exact``, as a conv epilogue uses them."""
    rng = np.random.default_rng(5)
    acc = rng.integers(-(1 << 19), 1 << 19, (3, 4, 5, 6), dtype=np.int64)
    qm, sh = jfp.quantize_multiplier_arr(rng.uniform(1e-4, 2e-2, 6))
    want = np.clip(np.asarray(jfp.multiply_by_quantized_multiplier(
        jnp.asarray(acc.astype(np.int32)), qm, sh)) - 7, -128, 127)
    got = tfp.requant_exact(torch.from_numpy(acc), torch.from_numpy(qm),
                            torch.from_numpy(sh), -7)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (np.abs(want) < 127).mean() < 1       # not all saturated
