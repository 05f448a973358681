"""Parity tests for dsp.fft vs numpy reference math, covering the reference
block's three special cases (lib/clFFT_impl.cc:544-630): forward+shift,
reverse+shift-on-load, and real-input hermitian mirror."""

import numpy as np
import pytest

from clenabled_tpu.dsp import fft as clfft
from clenabled_tpu.dsp import window as win

RNG = np.random.default_rng(42)


def cplx(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(
        np.complex64
    )


def test_forward_complex_unscaled():
    x = cplx(4, 256)
    got = np.asarray(clfft.fft(x, clfft.FORWARD))
    np.testing.assert_allclose(got, np.fft.fft(x, axis=-1), rtol=1e-4, atol=1e-3)


def test_reverse_complex_unscaled():
    # reverse is the UNSCALED inverse DFT (backward scale forced 1.0)
    x = cplx(3, 128)
    got = np.asarray(clfft.fft(x, clfft.REVERSE))
    np.testing.assert_allclose(got, np.fft.ifft(x, axis=-1) * 128, rtol=1e-4, atol=1e-3)


def test_roundtrip_scale_is_n():
    # fwd∘rev with both unscaled multiplies by N — the reference's convention
    x = cplx(2, 64)
    y = clfft.fft(clfft.fft(x, clfft.FORWARD), clfft.REVERSE)
    np.testing.assert_allclose(np.asarray(y), x * 64, rtol=1e-4, atol=1e-3)


def test_forward_shift_is_fftshift():
    x = cplx(2, 128)
    got = np.asarray(clfft.fft(x, clfft.FORWARD, shift=True))
    np.testing.assert_allclose(
        got, np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1), rtol=1e-4, atol=1e-3
    )


def test_reverse_shift_swaps_halves_on_load():
    # reverse+shift loads [x[N/2:], x[:N/2]] then transforms (clFFT_impl.cc:549-563)
    x = cplx(2, 128)
    swapped = np.concatenate([x[:, 64:], x[:, :64]], axis=-1)
    want = np.fft.ifft(swapped, axis=-1) * 128
    got = np.asarray(clfft.fft(x, clfft.REVERSE, shift=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_window_applied_before_transform():
    x = cplx(2, 256)
    w = win.hamming(256)
    got = np.asarray(clfft.fft(x, clfft.FORWARD, window=w))
    np.testing.assert_allclose(got, np.fft.fft(x * w, axis=-1), rtol=1e-4, atol=1e-3)


def test_reverse_shift_window_order():
    # window multiplies the already-swapped buffer (kernel runs after load)
    x = cplx(1, 64)
    w = win.hann(64)
    swapped = np.concatenate([x[:, 32:], x[:, :32]], axis=-1)
    want = np.fft.ifft(swapped * w, axis=-1) * 64
    got = np.asarray(clfft.fft(x, clfft.REVERSE, window=w, shift=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_real_forward_full_hermitian_spectrum():
    x = RNG.standard_normal((3, 128)).astype(np.float32)
    got = np.asarray(clfft.fft(x, clfft.FORWARD))
    want = np.fft.fft(x, axis=-1)  # full complex spectrum of real input
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_fft_stream_chops_into_vectors():
    x = cplx(512)
    got = np.asarray(clfft.fft_stream(x, 128))
    want = np.fft.fft(x.reshape(4, 128), axis=-1).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_window_length_validated():
    import pytest

    with pytest.raises(ValueError):
        clfft.fft(cplx(2, 128), clfft.FORWARD, window=win.hamming(64))


def _np_fft_stream(x, size, direction, window, shift):
    """float64 NumPy oracle of the reference block's stream semantics."""
    v = np.asarray(x, np.complex128).reshape(-1, size)
    h = size // 2
    if direction == clfft.FORWARD:
        if window is not None:
            v = v * np.asarray(window)
        y = np.fft.fft(v, axis=-1)
        if shift:
            y = np.fft.fftshift(y, axes=-1)
    else:
        if shift:
            v = np.concatenate([v[:, h:], v[:, :h]], axis=-1)
        if window is not None:
            v = v * np.asarray(window)
        y = np.fft.ifft(v, axis=-1) * size
    return y.reshape(-1)


@pytest.mark.parametrize("size", [1024, 2048, 4096])
def test_fft_stream_planar_matches_numpy(size):
    """fft_stream_planar (two-stage DFT matmuls) against the NumPy oracle
    for every direction/shift/window combination the block layer uses."""
    import jax.numpy as jnp

    from clenabled_tpu.dsp import planar

    rng = np.random.default_rng(13)
    n = size * 6
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    x = planar.PC(jnp.asarray(xr), jnp.asarray(xi))
    w = win.blackman_harris(size)
    for direction in (clfft.FORWARD, clfft.REVERSE):
        for shift in (False, True):
            for window in (None, w):
                got = clfft.fft_stream_planar(
                    x, size, direction=direction, window=window, shift=shift)
                want = _np_fft_stream(xr + 1j * xi, size, direction, window,
                                      shift)
                scale = float(np.abs(want).max())
                np.testing.assert_allclose(
                    np.asarray(got.re) + 1j * np.asarray(got.im), want,
                    rtol=1e-4, atol=1e-4 * scale,
                    err_msg=f"dir={direction} shift={shift} "
                            f"win={window is not None}")


def test_fft_block_planar_stream_matches_numpy():
    """The Fft block on a planar stream (shifted forward transform)
    against the NumPy oracle."""
    import jax.numpy as jnp

    from clenabled_tpu import blocks
    from clenabled_tpu.dsp import planar

    rng = np.random.default_rng(3)
    n = 1024 * 4
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    b = blocks.Fft(1024, shift=True)
    _, (got,), _ = b.apply(b.init_state(),
                           [planar.PC(jnp.asarray(xr), jnp.asarray(xi))])
    want = _np_fft_stream(xr + 1j * xi, 1024, clfft.FORWARD, None, True)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got.re) + 1j * np.asarray(got.im),
                               want, rtol=1e-4, atol=1e-4 * scale)
