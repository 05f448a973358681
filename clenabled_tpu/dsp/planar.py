"""Planar complex arithmetic: complex streams as (re, im) float32 pairs.

Every complex matmul becomes exactly 4 real matmuls and elementwise complex
ops stay fused real code.  The planar path runs beside the complex64 API
elsewhere; which of the two stays is an open design question (see
ROADMAP.md, D3).

FFTs are computed as DFT matmuls (single-stage for small N, two-stage
Cooley-Tukey N = N1·N2 for large N — O(N·(N1+N2)) MACs).  Sign/scale
conventions match the rest of the framework: forward unscaled, inverse
unscaled (the reference forces clFFT's backward scale to 1.0,
lib/clFFT_impl.cc:121-122).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PC(NamedTuple):
    """A planar complex array: two same-shape float32 arrays."""
    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape


def from_complex(x) -> PC:
    """Host-side split."""
    x = np.asarray(x)
    return PC(jnp.asarray(x.real, jnp.float32), jnp.asarray(x.imag, jnp.float32))


def to_complex(x: PC) -> np.ndarray:
    """Host-side join."""
    return np.asarray(x.re).astype(np.complex64) + 1j * np.asarray(x.im)


def zeros(shape, *_args) -> PC:
    return PC(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


def add(a: PC, b: PC) -> PC:
    return PC(a.re + b.re, a.im + b.im)


def sub(a: PC, b: PC) -> PC:
    return PC(a.re - b.re, a.im - b.im)


def mul(a: PC, b: PC) -> PC:
    return PC(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def mul_conj(a: PC, b: PC) -> PC:
    """a * conj(b) — the correlator primitive (cxmac form)."""
    return PC(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def conj(a: PC) -> PC:
    return PC(a.re, -a.im)


def scale(a: PC, s) -> PC:
    return PC(a.re * s, a.im * s)


def abs2(a: PC):
    return a.re * a.re + a.im * a.im


def pabs(a: PC):
    return jnp.sqrt(abs2(a))


def _fft_factors(n: int) -> tuple[int, int]:
    """Split n into two near-sqrt factors (n must be composite for the
    two-stage path; powers of two always are)."""
    best = (1, n)
    for f in range(2, int(math.isqrt(n)) + 1):
        if n % f == 0:
            best = (f, n // f)
    return best


@lru_cache(maxsize=None)
def _dft_consts(n: int, sign: int):
    """(Fr, Fi) for the n-point DFT matrix W[k,m] = exp(sign·2πi·k·m/n),
    host-precomputed in float64 then cast."""
    k = np.arange(n)
    ang = sign * 2.0 * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@lru_cache(maxsize=None)
def _twiddle_consts(n1: int, n2: int, sign: int):
    """T[k2, n1] = exp(sign·2πi·n1·k2/(n1·n2))."""
    ang = sign * 2.0 * np.pi * np.outer(np.arange(n2), np.arange(n1)) / (n1 * n2)
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _cmatmul_right(x: PC, fr, fi) -> PC:
    """y[..., k] = Σ_n F[k,n] x[..., n] as 4 real matmuls."""
    yr = (jnp.einsum("...n,kn->...k", x.re, fr,
                     preferred_element_type=jnp.float32)
          - jnp.einsum("...n,kn->...k", x.im, fi,
                       preferred_element_type=jnp.float32))
    yi = (jnp.einsum("...n,kn->...k", x.re, fi,
                     preferred_element_type=jnp.float32)
          + jnp.einsum("...n,kn->...k", x.im, fr,
                       preferred_element_type=jnp.float32))
    return PC(yr, yi)


# Below this size a single dense DFT matmul is used instead of the
# two-stage form's extra transposes and twiddles.
_SINGLE_STAGE_MAX = 256


def fft(x: PC, inverse: bool = False) -> PC:
    """Unscaled DFT along the last axis (inverse = conjugate kernel, still
    unscaled — multiply by nothing, matching the framework's clFFT
    convention).  Static shape; jit-friendly."""
    n = x.re.shape[-1]
    sign = 1 if inverse else -1
    if n <= _SINGLE_STAGE_MAX or _fft_factors(n)[0] == 1:
        fr, fi = _dft_consts(n, sign)
        return _cmatmul_right(x, jnp.asarray(fr), jnp.asarray(fi))
    n1, n2 = _fft_factors(n)
    # x[..., n] with n = N1*m2 + m1  →  x2[..., m2, m1]
    x2 = PC(x.re.reshape(x.re.shape[:-1] + (n2, n1)),
            x.im.reshape(x.im.shape[:-1] + (n2, n1)))
    # stage 1: DFT_N2 over m2 → y[..., k2, m1]
    f2r, f2i = _dft_consts(n2, sign)
    f2r, f2i = jnp.asarray(f2r), jnp.asarray(f2i)
    yr = (jnp.einsum("kn,...nm->...km", f2r, x2.re,
                     preferred_element_type=jnp.float32)
          - jnp.einsum("kn,...nm->...km", f2i, x2.im,
                       preferred_element_type=jnp.float32))
    yi = (jnp.einsum("kn,...nm->...km", f2i, x2.re,
                     preferred_element_type=jnp.float32)
          + jnp.einsum("kn,...nm->...km", f2r, x2.im,
                       preferred_element_type=jnp.float32))
    # twiddle: × exp(sign·2πi·m1·k2/N)
    tr, ti = _twiddle_consts(n1, n2, sign)
    y = mul(PC(yr, yi), PC(jnp.asarray(tr), jnp.asarray(ti)))
    # stage 2: DFT_N1 over m1 → X[..., k2, k1]
    f1r, f1i = _dft_consts(n1, sign)
    f1r, f1i = jnp.asarray(f1r), jnp.asarray(f1i)
    zr = (jnp.einsum("kn,...mn->...mk", f1r, y.re,
                     preferred_element_type=jnp.float32)
          - jnp.einsum("kn,...mn->...mk", f1i, y.im,
                       preferred_element_type=jnp.float32))
    zi = (jnp.einsum("kn,...mn->...mk", f1i, y.re,
                     preferred_element_type=jnp.float32)
          + jnp.einsum("kn,...mn->...mk", f1r, y.im,
                       preferred_element_type=jnp.float32))
    # output order k = N2*k1 + k2: [..., k2, k1] → [..., k1, k2] → flat
    zr = jnp.swapaxes(zr, -1, -2).reshape(x.re.shape)
    zi = jnp.swapaxes(zi, -1, -2).reshape(x.im.shape)
    return PC(zr, zi)


def ifft_unscaled(x: PC) -> PC:
    """Inverse kernel without 1/N — equal to the reference's backward
    transform with scale forced 1.0."""
    return fft(x, inverse=True)


def ifft(x: PC) -> PC:
    """Conventional scaled inverse (1/N) for callers that need numpy
    semantics."""
    n = x.re.shape[-1]
    return scale(fft(x, inverse=True), 1.0 / n)


def fftshift(x: PC, axis: int = -1) -> PC:
    n = x.re.shape[axis]
    return PC(jnp.roll(x.re, n // 2, axis), jnp.roll(x.im, n // 2, axis))
