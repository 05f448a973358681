"""FFT with gr-clenabled's window/shift/hermitian semantics.

Replaces the reference's clFFT plan + generated window-multiply kernel
(lib/clFFT_impl.cc).  Semantics reproduced exactly:

- Forward and backward transforms are UNSCALED — the reference forces both
  clFFT scales to 1.0 (lib/clFFT_impl.cc:121-122), so "reverse" here is the
  plain inverse-DFT sum (``jnp.fft.ifft(x) * N``), NOT jnp's 1/N-scaled ifft.
- Optional window taps multiply the (loaded) input in place before the
  transform (lib/clFFT_impl.cc:202-271, applied :567-580).
- ``shift`` semantics differ by direction (lib/clFFT_impl.cc:544-607):
  forward+shift applies an output fftshift (complex input only);
  reverse+shift swaps the input halves on load (an ifftshift) BEFORE the
  window multiply and transform.
- Float (real) input, forward: the reference computes a real→hermitian
  transform and conjugate-mirrors the half spectrum into a full complex
  spectrum (lib/clFFT_impl.cc:608-630).  We produce the mathematically exact
  full spectrum (y[k] = conj(y[N-k]) for k>N/2); the reference's mirror loop
  has an off-by-one at the Nyquist bin which we do not reproduce.

All functions are batched: input shape [..., fft_size], jit-friendly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

FORWARD = 1   # mirrors clFFT CLFFT_FORWARD semantics
REVERSE = -1  # mirrors CLFFT_BACKWARD


def _check_window(window, fft_size):
    if window is None:
        return None
    window = jnp.asarray(window, dtype=jnp.float32)
    if window.shape[-1] != fft_size:
        # reference validates window length against fft size (clFFT_impl.cc:74-76)
        raise ValueError(
            f"window length {window.shape[-1]} != fft_size {fft_size}"
        )
    return window


@partial(jax.jit, static_argnames=("shift",))
def _fft_complex_forward(x, window, shift):
    if window is not None:
        x = x * window
    y = jnp.fft.fft(x, axis=-1)
    if shift:
        y = jnp.fft.fftshift(y, axes=-1)
    return y.astype(jnp.complex64)


@partial(jax.jit, static_argnames=("shift",))
def _fft_complex_reverse(x, window, shift):
    n = x.shape[-1]
    if shift:
        # reverse+shift: swap halves on buffer load (clFFT_impl.cc:549-563)
        x = jnp.concatenate([x[..., n // 2:], x[..., : n // 2]], axis=-1)
    if window is not None:
        x = x * window
    y = jnp.fft.ifft(x, axis=-1) * n  # backward scale forced to 1.0
    return y.astype(jnp.complex64)


@jax.jit
def _fft_real_forward(x, window):
    n = x.shape[-1]
    if window is not None:
        x = x * window
    half = jnp.fft.rfft(x, axis=-1)  # [..., n//2+1]
    # full spectrum by hermitian mirror: y[k] = conj(y[n-k]) for k > n/2
    mirror = jnp.conj(half[..., 1 : n // 2])[..., ::-1]
    y = jnp.concatenate([half, mirror], axis=-1)
    return y.astype(jnp.complex64)


def fft_planar(x, direction: int = FORWARD, window=None, shift: bool = False):
    """Planar-complex fft() with identical clFFT semantics (x is a
    planar.PC of [..., fft_size])."""
    from clenabled_tpu.dsp import planar

    n = x.re.shape[-1]
    window = _check_window(window, n)
    if direction == FORWARD:
        if window is not None:
            x = planar.PC(x.re * window, x.im * window)
        y = planar.fft(x)
        if shift:
            y = planar.fftshift(y)
        return y
    if shift:
        x = planar.PC(
            jnp.concatenate([x.re[..., n // 2:], x.re[..., : n // 2]], -1),
            jnp.concatenate([x.im[..., n // 2:], x.im[..., : n // 2]], -1))
    if window is not None:
        x = planar.PC(x.re * window, x.im * window)
    return planar.ifft_unscaled(x)


def fft_stream_planar(x, fft_size: int, direction: int = FORWARD,
                      window=None, shift: bool = False):
    """Planar fft_stream: PC of 1-D streams chopped into fft_size
    vectors."""
    from clenabled_tpu.dsp import planar

    if x.re.shape[-1] % fft_size:
        raise ValueError("stream length must be a multiple of fft_size")
    shp = x.re.shape[:-1] + (-1, fft_size)
    out = fft_planar(planar.PC(x.re.reshape(shp), x.im.reshape(shp)),
                     direction=direction, window=window, shift=shift)
    flat = x.re.shape[:-1] + (-1,)
    return planar.PC(out.re.reshape(flat), out.im.reshape(flat))


def fft(x, direction: int = FORWARD, window=None, shift: bool = False):
    """Transform batched vectors with the reference block's semantics.

    Args:
      x: [..., fft_size]; complex64 (DTYPE_COMPLEX) or float32 (DTYPE_FLOAT).
      direction: FORWARD or REVERSE.
      window: optional float32 taps of length fft_size.
      shift: center-DC behavior (see module docstring).

    Returns:
      complex64 [..., fft_size].
    """
    x = jnp.asarray(x)
    fft_size = x.shape[-1]
    window = _check_window(window, fft_size)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(jnp.complex64)
        if direction == FORWARD:
            return _fft_complex_forward(x, window, shift)
        return _fft_complex_reverse(x, window, shift)
    # float input
    x = x.astype(jnp.float32)
    if direction == FORWARD:
        # shift not applied on the float/hermitian path (clFFT_impl.cc:594-630)
        return _fft_real_forward(x, window)
    # float reverse: hermitian->real inverse, unscaled, returned as complex
    y = jnp.fft.ifft(x.astype(jnp.complex64), axis=-1) * fft_size
    return y.astype(jnp.complex64)


def fft_stream(x, fft_size: int, direction: int = FORWARD, window=None,
               shift: bool = False):
    """Stream form: 1-D sample stream chopped into fft_size vectors
    (the reference block is stream→vector with vlen=fft_size)."""
    x = jnp.asarray(x)
    if x.shape[-1] % fft_size:
        raise ValueError("stream length must be a multiple of fft_size")
    batched = x.reshape(x.shape[:-1] + (-1, fft_size))
    out = fft(batched, direction=direction, window=window, shift=shift)
    return out.reshape(x.shape[:-1] + (-1,))
