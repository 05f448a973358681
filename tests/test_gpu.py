"""Tests that run only on an NVIDIA GPU (marker ``gpu``; they skip
elsewhere).  Run them on a GPU host with:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clenabled_tpu import reference
from clenabled_tpu.dsp import xengine
from clenabled_tpu.pipelines import (FxPipelineConfig, flagship_taps,
                                     make_fx_pipeline,
                                     make_fx_pipeline_planar)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["planar", "complex"])
def test_flagship_on_gpu_matches_reference_highest(form):
    """Both flagship forms on the card at 2^16 samples under "highest"
    matmul precision: float32 products and sums over 2^12 frames, so
    1e-4 normwise is a wide margin."""
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << 16)
    taps = flagship_taps(16)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 1 << 16))
         + 1j * rng.standard_normal((4, 1 << 16))).astype(np.complex64)
    fd_w, xm_w, _ = reference.flagship_step(
        x, np.zeros((4, len(taps) - 1)), taps, 16)
    with jax.default_matmul_precision("highest"):
        if form == "planar":
            fn, (_, _, hr, hi) = make_fx_pipeline_planar(cfg)
            fd, xre, xim, _, _ = fn(x.real.copy(), x.imag.copy(), hr, hi)
            xm = np.asarray(xre) + 1j * np.asarray(xim)
        else:
            fn, (_, hist) = make_fx_pipeline(cfg)
            fd, xm, _ = fn(x, hist)
    assert reference.normwise_rel_err(fd, fd_w) < 1e-4
    assert reference.normwise_rel_err(xm, xm_w) < 1e-4


@pytest.mark.gpu
def test_int8_gram_on_gpu_is_exact():
    """The s8×s8→s32 stacked Gram on the card equals the NumPy int64
    Gram integer for integer."""
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (2, 8, 1024, 128)).astype(np.int64)
    gr, gi = jax.jit(xengine.xengine_gram_stacked)(
        jnp.asarray(q[0], jnp.int8), jnp.asarray(q[1], jnp.int8))
    b = np.einsum("ftk,ftl->fkl", q[1], q[0])
    np.testing.assert_array_equal(
        np.asarray(gr, np.int64),
        np.einsum("ftk,ftl->fkl", q[0], q[0])
        + np.einsum("ftk,ftl->fkl", q[1], q[1]))
    np.testing.assert_array_equal(np.asarray(gi, np.int64),
                                  b - np.swapaxes(b, -1, -2))
