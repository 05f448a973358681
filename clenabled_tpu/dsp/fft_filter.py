"""Overlap-add fast convolution (FFT filter) with explicit carried tail.

Replaces the reference's ``fft_filter_ccf`` (lib/fft_filter.cc:133-175) and
the clFilter frequency-domain path (lib/clFilter_impl.cc:592-681).  Sizing
matches the reference exactly (lib/fft_filter.cc:77-78):

    fftsize  = 2 * next_pow2(ntaps)
    nsamples = fftsize - ntaps + 1            (samples consumed per chunk)
    tailsize = ntaps - 1                      (carried between calls)

The reference runs chunks sequentially, adding the previous chunk's tail into
the current output (:156-171).  Because ``tailsize < nsamples`` always holds
with this sizing, a tail only ever reaches the NEXT chunk — so a whole frame
of B chunks is computed as one batched FFT→multiply→IFFT (one XLA
program) and the overlap-add becomes a shifted add between
neighboring rows.  Only the final tail is carried state.

Decimation reproduces the reference's strided copy-out with carried phase
(dec_ctr, :161-167): requiring the frame to be a multiple of
``lcm(nsamples) * decimation`` alignment keeps the phase zero at frame
boundaries, exactly as GR's scheduler guarantees for the reference.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def compute_sizes(ntaps: int) -> tuple[int, int]:
    """(fftsize, nsamples) per lib/fft_filter.cc:77-78."""
    fftsize = int(2 * (2 ** math.ceil(math.log2(ntaps))))
    return fftsize, fftsize - ntaps + 1


class FftFilterPlan(NamedTuple):
    """Design-time constants (the analogue of the baked clFFT plan +
    pre-transformed taps, lib/fft_filter.cc:40-68).  xformed_taps stays a
    host numpy array; the planar path splits it into float32 parts."""
    xformed_taps: np.ndarray  # [fftsize] complex64: FFT of zero-padded taps
    ntaps: int
    fftsize: int
    nsamples: int
    decimation: int


def plan_fft_filter(taps, decimation: int = 1) -> FftFilterPlan:
    taps = np.asarray(taps)
    ntaps = int(taps.shape[-1])
    fftsize, nsamples = compute_sizes(ntaps)
    padded = np.zeros(fftsize, dtype=np.complex64)
    padded[:ntaps] = taps.astype(np.complex64)
    # net scaling matches the reference (taps pre-scaled 1/fftsize, both
    # transforms unscaled): equivalent to standard fft/ifft pair here.
    xt = np.fft.fft(padded).astype(np.complex64)
    return FftFilterPlan(xformed_taps=xt, ntaps=ntaps, fftsize=fftsize,
                         nsamples=nsamples, decimation=decimation)


def frame_quantum(plan) -> int:
    """Smallest valid frame length: a multiple of the plan's chunk grain
    whose output count is integral (lcm with the decimation)."""
    base = plan.nsamples
    q = base
    while q % plan.decimation:
        q += base
    return q


@partial(jax.jit, static_argnames=("nsamples", "fftsize", "ntaps", "decimation"))
def _ofa_filter(x, tail, xformed_taps, *, nsamples, fftsize, ntaps, decimation):
    nchunks = x.shape[-1] // nsamples
    xb = x.reshape(nchunks, nsamples)
    pad = jnp.zeros((nchunks, fftsize - nsamples), dtype=jnp.complex64)
    spect = jnp.fft.fft(jnp.concatenate([xb, pad], axis=-1), axis=-1)
    z = jnp.fft.ifft(spect * xformed_taps, axis=-1)
    tails = z[:, nsamples:]  # [nchunks, ntaps-1]
    prev_tails = jnp.concatenate([tail[None, :], tails[:-1]], axis=0)
    body = z[:, :nsamples].at[:, : ntaps - 1].add(prev_tails)
    y = body.reshape(-1)
    if decimation > 1:
        y = y[::decimation]
    return y.astype(jnp.complex64), tails[-1].astype(jnp.complex64)


@partial(jax.jit, static_argnames=("nsamples", "fftsize", "ntaps", "decimation"))
def _ofa_filter_planar(xr, xi, tail_r, tail_i, taps_r, taps_i, *, nsamples,
                       fftsize, ntaps, decimation):
    """Planar (complex-free) overlap-add — same math as _ofa_filter with the
    chunk FFTs as matmul DFTs (dsp.planar)."""
    from clenabled_tpu.dsp import planar

    nchunks = xr.shape[-1] // nsamples
    pad = jnp.zeros((nchunks, fftsize - nsamples), jnp.float32)
    xb = planar.PC(
        jnp.concatenate([xr.reshape(nchunks, nsamples), pad], axis=-1),
        jnp.concatenate([xi.reshape(nchunks, nsamples), pad], axis=-1))
    spect = planar.fft(xb)
    z = planar.ifft(planar.mul(spect, planar.PC(taps_r, taps_i)))
    tails_r, tails_i = z.re[:, nsamples:], z.im[:, nsamples:]
    prev_r = jnp.concatenate([tail_r[None, :], tails_r[:-1]], axis=0)
    prev_i = jnp.concatenate([tail_i[None, :], tails_i[:-1]], axis=0)
    yr = z.re[:, :nsamples].at[:, : ntaps - 1].add(prev_r).reshape(-1)
    yi = z.im[:, :nsamples].at[:, : ntaps - 1].add(prev_i).reshape(-1)
    if decimation > 1:
        yr, yi = yr[::decimation], yi[::decimation]
    return yr, yi, tails_r[-1], tails_i[-1]


def make_fft_filter_planar(taps, decimation: int = 1):
    """Planar streaming OFA filter: (init_state, apply, plan) with
    apply((tail_r, tail_i), frame: planar.PC) → (state, planar.PC)."""
    from clenabled_tpu.dsp import planar

    plan = plan_fft_filter(taps, decimation)
    quantum = frame_quantum(plan)
    taps_r = jnp.asarray(plan.xformed_taps.real.copy(), jnp.float32)
    taps_i = jnp.asarray(plan.xformed_taps.imag.copy(), jnp.float32)

    def init_state(frame_size: int | None = None):
        del frame_size
        z = jnp.zeros((plan.ntaps - 1,), jnp.float32)
        return (z, jnp.zeros_like(z))

    def apply(state, frame):
        if frame.re.shape[-1] % quantum:
            raise ValueError(
                f"frame length {frame.re.shape[-1]} must be a multiple of "
                f"{quantum}")
        yr, yi, tr, ti = _ofa_filter_planar(
            frame.re, frame.im, state[0], state[1], taps_r, taps_i,
            nsamples=plan.nsamples, fftsize=plan.fftsize,
            ntaps=plan.ntaps, decimation=plan.decimation)
        return (tr, ti), planar.PC(yr, yi)

    return init_state, apply, plan


def make_fft_filter(taps, decimation: int = 1):
    """Streaming overlap-add filter: (init_state, apply, plan).

    apply(tail, frame) -> (new_tail, out).  ``frame`` length must be a
    multiple of ``frame_quantum(plan)``; out has len(frame)/decimation
    samples.
    """
    plan = plan_fft_filter(taps, decimation)
    quantum = frame_quantum(plan)
    xformed = jnp.asarray(plan.xformed_taps)  # device-resident once

    def init_state(frame_size: int | None = None):
        del frame_size
        return jnp.zeros((plan.ntaps - 1,), dtype=jnp.complex64)

    def apply(tail, frame):
        frame = jnp.asarray(frame, jnp.complex64)
        if frame.shape[-1] % quantum:
            raise ValueError(
                f"frame length {frame.shape[-1]} must be a multiple of "
                f"{quantum} (nsamples={plan.nsamples}, decim={decimation})"
            )
        out, new_tail = _ofa_filter(
            frame, tail, xformed,
            nsamples=plan.nsamples, fftsize=plan.fftsize,
            ntaps=plan.ntaps, decimation=plan.decimation,
        )
        return new_tail, out

    return init_state, apply, plan


def fft_filter(x, taps, decimation: int = 1):
    """One-shot convenience over a zero initial tail (reference
    ``fft_filter_ccf::filter`` on a fresh object)."""
    init, apply, plan = make_fft_filter(taps, decimation)
    _, y = apply(init(), x)
    return y
