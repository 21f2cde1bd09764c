"""The port's RGB565 preprocess (plain version of the CUDA kernel) against
the JAX XLA preprocess, the Pallas kernel in interpret mode and the
firmware vectors, bit for bit (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pipeline import firmware_preprocess_ref
from yoloface_tpu.kernels import pallas_int8 as pk
from yoloface_tpu.pipeline import preprocess as jpre
from yoloface_tpu_torch.kernels.preprocess import preprocess_rgb565
from yoloface_tpu_torch.pipeline import preprocess as tpre

torch.set_num_threads(1)


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 16, (n, 112, 112),
                        dtype=np.int64).astype(np.uint16)


@pytest.mark.parametrize("n", [1, 3])
def test_equals_jax_preprocess(n):
    f = _frames(n, n)
    np.testing.assert_array_equal(
        tpre.rgb565_to_int8_input(torch.from_numpy(f)).numpy(),
        np.asarray(jpre.rgb565_to_int8_input(f)))


def test_kernel_wrapper_equals_pallas_kernel_interpret():
    f = _frames(11, 2)
    # the Pallas kernel takes [W,H,N] and gives CWHN [3,56(W),56(H),N]
    cwhn = np.asarray(pk.preprocess_rgb565(jnp.transpose(jnp.asarray(f),
                                                         (2, 1, 0))))
    got = preprocess_rgb565(torch.from_numpy(f))
    assert got.shape == (2, 56, 56, 3) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), cwhn.transpose(3, 2, 1, 0))


def test_firmware_vectors():
    f = _frames(7, 2)
    got = tpre.rgb565_to_int8_input(torch.from_numpy(f)).numpy()
    for n in range(f.shape[0]):
        np.testing.assert_array_equal(got[n], firmware_preprocess_ref(f[n]))


def test_encode_rgb565_equals_jax():
    rgb = np.random.default_rng(8).integers(0, 256, (2, 112, 112, 3),
                                            dtype=np.int64).astype(np.uint8)
    np.testing.assert_array_equal(tpre.encode_rgb565(rgb),
                                  jpre.encode_rgb565(rgb))


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_rejects_bad_frames(bad):
    f = (torch.zeros((2, 56, 56), dtype=torch.uint16) if bad == "shape"
         else torch.zeros((2, 112, 112), dtype=torch.int32))
    with pytest.raises(ValueError):
        preprocess_rgb565(f)
