"""Plain float64 NumPy reference of the flagship pipeline.

Written from the definitions, independently of the code under test: the
critically sampled polyphase filterbank as a sum of shifted slices, the
channel spectra by ``np.fft``, the frequency-domain correlation of every
antenna against antenna 0 as conj-multiply → unscaled inverse FFT → |·| →
mean over frames → fftshift, and the X-Engine as one Gram matrix per
channel in xGPU triangular order.  The tests and ``chip_smoke.py`` compare
both flagship forms (pipelines.make_fx_pipeline and
make_fx_pipeline_planar) with it.
"""

from __future__ import annotations

import numpy as np


def pfb_critical(x, taps, num_channels: int):
    """Critically sampled PFB channelizer.

    x: [..., T-1 + N] samples with T-1 history samples in front; taps: [T]
    with T a multiple of num_channels (M).  Returns [..., N/M, M]
    complex128 spectra:

        acc[i, j]  = Σ_{k ≡ j (mod M)} taps[k] · x[i·M + T-1 - k]
        spec[i, c] = Σ_j acc[i, j] · exp(+2πi·j·c/M)   (unscaled inverse DFT)
    """
    m = num_channels
    x = np.asarray(x, np.complex128)
    taps = np.asarray(taps, np.float64)
    t = len(taps)
    if t % m:
        raise ValueError("taps must be padded to a multiple of num_channels")
    nout = (x.shape[-1] - (t - 1)) // m
    lead = x.shape[:-1]
    acc = np.zeros(lead + (nout, m), np.complex128)
    for w in range(t // m):
        # blk[i, j] = x[i·M + T-1 - w·M - j]: the M samples ending at
        # i·M + T-1 - w·M, newest first
        start = t - (w + 1) * m
        blk = x[..., start:start + nout * m].reshape(lead + (nout, m))
        acc += taps[w * m:(w + 1) * m] * blk[..., ::-1]
    return np.fft.ifft(acc, axis=-1) * m


def fd_xcorr_mean(spec):
    """spec [A, T, M] → [A-1, M]: |IFFT_unscaled(spec[0]·conj(spec[a]))|
    averaged over the T frames, fftshifted."""
    m = spec.shape[-1]
    prod = spec[:1] * np.conj(spec[1:])
    corr = np.abs(np.fft.ifft(prod, axis=-1) * m).mean(axis=1)
    return np.fft.fftshift(corr, axes=-1)


def xengine_triangular(spec):
    """spec [S, T, F] → [F, S(S+1)/2, 1]: G[f, s1, s2] = Σ_t z_s1·conj(z_s2)
    for the baselines s1 ≥ s2 in xGPU order (row by row)."""
    g = np.einsum("itf,jtf->fij", spec, np.conj(spec), optimize=True)
    pairs = [(s1, s2) for s1 in range(spec.shape[0]) for s2 in range(s1 + 1)]
    return np.stack([g[:, s1, s2] for s1, s2 in pairs], axis=1)[..., None]


def flagship_step(x, hist, taps, num_channels: int):
    """One flagship step on x [A, N] complex with history hist [A, T-1]:
    returns (fd [A-1, M] float64, xmat [M, nb, 1] complex128, new_hist)."""
    full = np.concatenate([np.asarray(hist, np.complex128),
                           np.asarray(x, np.complex128)], axis=-1)
    spec = pfb_critical(full, taps, num_channels)
    return (fd_xcorr_mean(spec), xengine_triangular(spec),
            full[:, full.shape[-1] - (len(taps) - 1):])


def normwise_rel_err(got, want) -> float:
    """‖got − want‖_F / ‖want‖_F in float64."""
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm((got - want).ravel())
                 / np.linalg.norm(want.ravel()))
