"""Time- and frequency-domain cross-correlators.

- ``td_xcorr`` replaces clXCorrelate's lag-scan kernel
  (lib/clXCorrelate_impl.cc:843-903): normalized cross-correlation of
  magnitude sequences over lags [-max_shift, max_shift), one value per lag:
      corr[l] = sum(x·y over the overlap) / sqrt(sum x² · sum y²)
  with -2.0 where the denominator is zero.  The reference runs one work-item
  per lag, each scalar-looping L samples, then a two-stage workgroup
  max-reduction (find_max, :1011-1068).  Here: ONE FFT cross-correlation
  gives every lag's numerator at once, prefix sums give every lag's window
  energies, and the reduction collapses to jnp.argmax.

- ``fd_xcorr`` replaces clxcorrelate_fft_vcf (lib/clxcorrelate_fft_vcf_impl.cc):
  per FFT-vector: ref × conj(sig) → unscaled reverse FFT → magnitude →
  half-swap (fftshift) into the output (:886-937, :1131-1141), optionally
  forward-transforming time-series input first (input_type=2, :1080-1086).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _mag(x):
    """Reference semantics: complex input → |x|; float input used as-is
    (lib/clXCorrelate_impl.cc:1483-1489)."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return jnp.abs(x).astype(jnp.float32)
    return x.astype(jnp.float32)


@partial(jax.jit, static_argnames=("max_shift",))
def _td_xcorr_pair(ref_mag, sig_mag, max_shift: int):
    """Normalized lag scan for one (ref, sig) magnitude pair.

    Returns corr: [2*max_shift] float32, lags g - max_shift for g in range.
    """
    n = ref_mag.shape[-1]
    xx = ref_mag * ref_mag
    yy = sig_mag * sig_mag
    # inclusive prefix sums with leading 0: csum[k] = sum of first k items
    cxx = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(xx)])
    cyy = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(yy)])

    # all-lag numerator via FFT cross-correlation:
    # c[l] = sum_i ref[i+l]·sig[i]  (l ≥ 0);  c_neg[s] = sum_i ref[i]·sig[i+s]
    p = 1
    while p < n + max_shift:
        p <<= 1
    fr = jnp.fft.rfft(ref_mag, n=p)
    fs = jnp.fft.rfft(sig_mag, n=p)
    cc = jnp.fft.irfft(fr * jnp.conj(fs), n=p)  # cc[l] = Σ ref[i+l] sig[i] (mod p)

    g = jnp.arange(2 * max_shift)
    shift = g - max_shift  # [-max_shift, max_shift)
    pos = shift > 0
    s_abs = jnp.abs(shift)

    # numerator: lag>0 → cc[shift]; lag≤0 → cc[p - s_abs] (wrap), lag 0 → cc[0]
    num = jnp.where(pos, cc[jnp.clip(shift, 0, p - 1)],
                    cc[jnp.where(s_abs == 0, 0, p - s_abs)])

    # window energies (reference :875-888):
    #   shift>0: sum xx[shift:]      · sum yy[:n-shift]
    #   shift≤0: sum xx[:n-s]        · sum yy[s:]
    total_xx = cxx[n]
    total_yy = cyy[n]
    sum_x2 = jnp.where(pos, total_xx - cxx[s_abs], cxx[n - s_abs])
    sum_y2 = jnp.where(pos, cyy[n - s_abs], total_yy - cyy[s_abs])

    denom = sum_x2 * sum_y2
    corr = jnp.where(denom != 0.0, num * jax.lax.rsqrt(denom), -2.0)
    return corr.astype(jnp.float32)


@partial(jax.jit, static_argnames=("max_shift",))
def _td_xcorr_pair_planar(ref_mag, sig_mag, max_shift: int):
    """Complex-free lag scan: identical to _td_xcorr_pair
    with the FFT cross-correlation done in planar form (matmul DFTs)."""
    from clenabled_tpu.dsp import planar

    n = ref_mag.shape[-1]
    xx = ref_mag * ref_mag
    yy = sig_mag * sig_mag
    cxx = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(xx)])
    cyy = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(yy)])

    p = 1
    while p < n + max_shift:
        p <<= 1
    zpad = jnp.zeros((p - n,), jnp.float32)
    fr = planar.fft(planar.PC(jnp.concatenate([ref_mag, zpad]),
                              jnp.zeros((p,), jnp.float32)))
    fs = planar.fft(planar.PC(jnp.concatenate([sig_mag, zpad]),
                              jnp.zeros((p,), jnp.float32)))
    cc = planar.ifft(planar.mul_conj(fr, fs)).re

    g = jnp.arange(2 * max_shift)
    shift = g - max_shift
    pos = shift > 0
    s_abs = jnp.abs(shift)
    num = jnp.where(pos, cc[jnp.clip(shift, 0, p - 1)],
                    cc[jnp.where(s_abs == 0, 0, p - s_abs)])
    total_xx = cxx[n]
    total_yy = cyy[n]
    sum_x2 = jnp.where(pos, total_xx - cxx[s_abs], cxx[n - s_abs])
    sum_y2 = jnp.where(pos, cyy[n - s_abs], total_yy - cyy[s_abs])
    denom = sum_x2 * sum_y2
    corr = jnp.where(denom != 0.0, num * jax.lax.rsqrt(denom), -2.0)
    return corr.astype(jnp.float32)


def td_xcorr_batched(signals, max_shift: int) -> "XCorrResult":
    """Many analysis windows per dispatch: signals [nsignals, B, n] →
    XCorrResult with leading [nsignals-1, B] dims.  The single-window form
    pays one dispatch per 8192-sample window (the reference's default);
    batching windows amortizes it."""
    signals = jnp.asarray(signals)
    mags = _mag(signals)
    ref = mags[0]                       # [B, n]
    pair = jax.vmap(lambda r, s: _td_xcorr_pair(r, s, max_shift))

    def one_sig(s):
        return pair(ref, s)             # [B, 2*max_shift]

    scan = jax.vmap(one_sig)(mags[1:])  # [nsig-1, B, 2*max_shift]
    best = jnp.argmax(scan, axis=-1)
    return XCorrResult(
        corr=jnp.take_along_axis(scan, best[..., None], axis=-1)[..., 0],
        lag=(best - max_shift).astype(jnp.int32),
        corr_vectors=scan,
    )


def td_xcorr_planar_batched(mags, max_shift: int) -> "XCorrResult":
    """Planar td_xcorr over batched windows: mags [nsignals, B, n] float32
    → XCorrResult with leading [nsignals-1, B] dims (the complex-free
    counterpart of td_xcorr_batched)."""
    mags = jnp.asarray(mags, jnp.float32)
    ref = mags[0]                       # [B, n]
    pair = jax.vmap(lambda r, s: _td_xcorr_pair_planar(r, s, max_shift))
    scan = jax.vmap(lambda s: pair(ref, s))(mags[1:])
    best = jnp.argmax(scan, axis=-1)
    return XCorrResult(
        corr=jnp.take_along_axis(scan, best[..., None], axis=-1)[..., 0],
        lag=(best - max_shift).astype(jnp.int32),
        corr_vectors=scan,
    )


def td_xcorr_planar(mags, max_shift: int) -> "XCorrResult":
    """Complex-free td_xcorr over magnitude (or real float) sequences
    [nsignals, n] — for complex streams, take planar.pabs first."""
    mags = jnp.asarray(mags, jnp.float32)
    ref = mags[0]
    scan = jax.vmap(lambda s: _td_xcorr_pair_planar(ref, s, max_shift))(mags[1:])
    best = jnp.argmax(scan, axis=-1)
    return XCorrResult(
        corr=jnp.take_along_axis(scan, best[:, None], axis=-1)[:, 0],
        lag=(best - max_shift).astype(jnp.int32),
        corr_vectors=scan,
    )


class XCorrResult(NamedTuple):
    """The PDU payload of clXCorrelate (:1594-1601): per non-reference
    signal, the best correlation and the corrective lag."""
    corr: jax.Array            # [nsignals-1] float32: max correlation
    lag: jax.Array             # [nsignals-1] int32: lag index - max_shift
    corr_vectors: jax.Array    # [nsignals-1, 2*max_shift] full scans


def td_xcorr(signals, max_shift: int) -> XCorrResult:
    """Correlate signals[1:] against signals[0].

    Args:
      signals: [nsignals, signal_length] complex64 or float32.
      max_shift: lag half-range (forced pow2 by the reference, :739-745 —
        not required here).
    """
    signals = jnp.asarray(signals)
    mags = _mag(signals)
    ref = mags[0]
    scan = jax.vmap(lambda s: _td_xcorr_pair(ref, s, max_shift))(mags[1:])
    best = jnp.argmax(scan, axis=-1)
    return XCorrResult(
        corr=jnp.take_along_axis(scan, best[:, None], axis=-1)[:, 0],
        lag=(best - max_shift).astype(jnp.int32),
        corr_vectors=scan,
    )


def fd_xcorr_planar(vectors, perform_fft_first: bool = False):
    """Planar-complex FD correlator: vectors is a planar.PC of
    [nsignals, ..., fft_size].  Same semantics as fd_xcorr, with the
    inverse DFT as a matmul."""
    from clenabled_tpu.dsp import planar

    v = vectors
    if perform_fft_first:
        v = planar.fft(v)
    n = v.re.shape[-1]
    ref = planar.PC(v.re[0], v.im[0])
    sig = planar.PC(v.re[1:], v.im[1:])
    prod = planar.mul_conj(ref, sig)
    z = planar.ifft_unscaled(prod)
    mag = planar.pabs(z)
    return jnp.roll(mag, n // 2, axis=-1)  # fftshift


@partial(jax.jit, static_argnames=("perform_fft_first",))
def fd_xcorr(vectors, perform_fft_first: bool = False):
    """Frequency-domain correlator over FFT-size vectors.

    Args:
      vectors: [nsignals, ..., fft_size] complex64 — spectra (input_type=1)
        or raw time series (input_type=2 → forward FFT applied first).

    Returns: [nsignals-1, ..., fft_size] float32 — fftshifted correlation
      magnitude vs the reference signal (signals[0]).
    """
    v = jnp.asarray(vectors, jnp.complex64)
    if perform_fft_first:
        v = jnp.fft.fft(v, axis=-1).astype(jnp.complex64)
    n = v.shape[-1]
    ref = v[0]
    prod = ref * jnp.conj(v[1:])
    z = jnp.fft.ifft(prod, axis=-1) * n  # reverse scale forced 1.0 (:731)
    mag = jnp.abs(z).astype(jnp.float32)
    return jnp.fft.fftshift(mag, axes=-1)
