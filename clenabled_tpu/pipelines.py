"""Flagship pipelines — the benchmark configurations from BASELINE.json.

The headline: a 4-antenna frequency-domain cross-correlator + polyphase
channelizer pipeline (north star ≥100 MSPS per device), plus its
time-sharded multi-device variant (ring-ppermute channelizer halos + psum
integration) used by __graft_entry__.dryrun_multichip and the scaling
benchmarks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from clenabled_tpu.dsp import channelizer as dsp_chan
from clenabled_tpu.dsp import firdes
from clenabled_tpu.dsp import planar
from clenabled_tpu.dsp import xcorr as dsp_xcorr
from clenabled_tpu.dsp import xengine as dsp_xengine


class FxPipelineConfig(NamedTuple):
    num_antennas: int = 4
    num_channels: int = 16
    samples_per_step: int = 1 << 17   # per antenna per step
    max_shift: int = 512              # (reserved for TD followups)


def flagship_taps(num_channels: int, samp_rate: float = 100e6,
                  proto_taps=None) -> np.ndarray:
    """The channelizer prototype, zero-padded to a multiple of
    ``num_channels``: ``proto_taps`` if given, else the default sharp
    low-pass (400 taps at 16 channels)."""
    m = num_channels
    if proto_taps is None:
        proto = firdes.low_pass(1.0, samp_rate, samp_rate / (2 * m) * 0.8,
                                samp_rate / (2 * m) * 0.2)
    else:
        proto = np.asarray(proto_taps, np.float32)
    return np.concatenate([proto, np.zeros((-len(proto)) % m, np.float32)])


def make_fx_pipeline(cfg: FxPipelineConfig = FxPipelineConfig(),
                     samp_rate: float = 100e6):
    """Single-device flagship: per antenna a 16-channel PFB channelizer,
    then a frequency-domain cross-correlation of every antenna against
    antenna 0 (clxcorrelate_fft_vcf role) and an X-Engine integration over
    the same spectra (clXEngine role) — the 'interferometry receive chain'
    of the reference's example flowgraphs, end to end in ONE jitted
    program.

    Returns (fn, example_args): fn(x, hist) with x [A, N] complex64 and
    hist [A, T-1] channelizer history → (fd_corr [A-1, F], xmatrix
    [F, nb, 1], new_hist).
    """
    a = cfg.num_antennas
    m = cfg.num_channels
    taps_rm, ntaps = dsp_chan._pfb_constants(flagship_taps(m, samp_rate),
                                             m, m)
    n = cfg.samples_per_step

    @jax.jit
    def fn(x, hist):
        full = jnp.concatenate([hist, x], axis=-1)  # [A, T-1+N]
        spectra = jax.vmap(
            lambda xa: dsp_chan._channelize(
                xa, taps_rm, jnp.arange(m, dtype=jnp.int32),
                num_channels=m, ninputs_per_iter=m, ntaps=ntaps)
        )(full)                                      # [A, N/M, M]
        new_hist = full[:, full.shape[-1] - (ntaps - 1):]
        # FD xcorr of each antenna vs antenna 0, averaged over vector frames
        fd = dsp_xcorr.fd_xcorr(spectra)             # [A-1, N/M, M]
        fd_avg = fd.mean(axis=1)                     # [A-1, M]
        # X-Engine over the channelized spectra: [T=N/M, S=A, F=M, P=1]
        z = jnp.transpose(spectra, (1, 0, 2))[..., None]
        xmat = dsp_xengine.xengine_correlate(z, npol=1)
        return fd_avg, xmat, new_hist

    x = jnp.zeros((a, n), jnp.complex64)
    hist = jnp.zeros((a, ntaps - 1), jnp.complex64)
    return fn, (x, hist)


def _fx_planar_core(full_re, full_im, taps_rm, m: int, ntaps: int,
                    nout: int):
    """Channelize planar streams [A, T-1+nout·M] and correlate them.

    Returns (corr_sum [A-1, M], xmat planar.PC [F, nb, 1]): the FD
    correlation magnitudes of every antenna against antenna 0 SUMMED over
    the nout frames (not yet averaged or fftshifted, so time shards can
    psum them) and the X-Engine Gram over the same spectra."""
    a = full_re.shape[0]
    # one packed PFB over all antennas × (re, im) at once
    comps = jnp.concatenate([full_re, full_im], axis=0)         # [2A, L]
    acc = dsp_chan._branch_sums_critical_batched(
        comps, taps_rm, m, ntaps, nout)                          # [2A, N/M, M]
    z2 = planar.ifft_unscaled(planar.PC(acc[:a], acc[a:]))
    # spectra in [time, antenna, channel] — the layout both consumers take
    spec = planar.PC(jnp.transpose(z2.re, (1, 0, 2)),
                     jnp.transpose(z2.im, (1, 0, 2)))
    ref = planar.PC(spec.re[:, :1, :], spec.im[:, :1, :])
    sig = planar.PC(spec.re[:, 1:, :], spec.im[:, 1:, :])
    prod = planar.mul_conj(ref, sig)                             # [T, A-1, M]
    corr_sum = planar.pabs(planar.ifft_unscaled(prod)).sum(axis=0)
    xz = planar.PC(spec.re[..., None], spec.im[..., None])
    return corr_sum, dsp_xengine.xengine_correlate_planar(xz, npol=1)


def make_fx_pipeline_planar(cfg: FxPipelineConfig = FxPipelineConfig(),
                            samp_rate: float = 100e6, proto_taps=None,
                            in_dtype=jnp.float32):
    """Planar-complex flagship (no complex64 anywhere; see dsp.planar).

    fn(xr, xi, hr, hi) → (fd_avg, xmat_re, xmat_im, new_hr, new_hi).
    xr/xi [A, N] are ``in_dtype``: float32, or the narrow ingest types
    bfloat16 and int8 (the reference's IChar samples, used raw,
    lib/clXEngine_impl.cc:831-858), which are widened to float32 on the
    device before the PFB.  hr/hi [A, T-1] and every output are float32.
    proto_taps overrides the channelizer prototype (any depth)."""
    a = cfg.num_antennas
    m = cfg.num_channels
    taps_rm, ntaps = dsp_chan._pfb_constants(
        flagship_taps(m, samp_rate, proto_taps), m, m)
    n = cfg.samples_per_step
    nout = n // m

    @jax.jit
    def fn(xr, xi, hr, hi):
        full_re = jnp.concatenate([hr, xr.astype(jnp.float32)], axis=-1)
        full_im = jnp.concatenate([hi, xi.astype(jnp.float32)], axis=-1)
        corr_sum, xmat = _fx_planar_core(full_re, full_im, taps_rm, m,
                                         ntaps, nout)
        fd = jnp.roll(corr_sum / nout, m // 2, axis=-1)          # [A-1, M]
        k = full_re.shape[-1] - (ntaps - 1)
        return fd, xmat.re, xmat.im, full_re[:, k:], full_im[:, k:]

    x = jnp.zeros((a, n), in_dtype)
    hist = jnp.zeros((a, ntaps - 1), jnp.float32)
    return fn, (x, x, hist, hist)


def make_sharded_fx_pipeline(mesh: Mesh, axis: str = "shard",
                             cfg: FxPipelineConfig = FxPipelineConfig(),
                             samp_rate: float = 100e6, in_dtype=jnp.float32):
    """Multi-device planar flagship step over a mesh: the antenna streams
    are TIME-sharded (each device channelizes its time slice; the
    channelizer halo arrives from the left neighbour by ring ppermute) and
    the FD-correlation sums and X-Engine Gram are psum-reduced across the
    mesh (integration is a sum over time).  Collectives per step: 2
    ppermutes (re/im halo) + psums.

    cfg.samples_per_step is the per-device block.  fn(xr, xi, hr, hi) with
    xr/xi [A, D·L] time-sharded (``in_dtype`` as in make_fx_pipeline_planar)
    and hr/hi [A, T-1] float32 replicated → the outputs of
    make_fx_pipeline_planar on the whole D·L-sample step.
    """
    a = cfg.num_antennas
    m = cfg.num_channels
    d = mesh.shape[axis]
    taps_rm, ntaps = dsp_chan._pfb_constants(flagship_taps(m, samp_rate),
                                             m, m)
    n_local = cfg.samples_per_step
    if n_local < ntaps - 1:
        raise ValueError(
            f"per-shard block ({n_local}) must be >= the "
            f"channelizer halo ({ntaps - 1} samples)")
    nout_local = n_local // m
    perm = [(j, (j + 1) % d) for j in range(d)]

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(None, axis), P(None, axis), P(), P()),
             out_specs=(P(), P(), P(), P(), P()))
    def fn(xr, xi, hr, hi):  # local xr/xi [A, L], hr/hi [A, T-1]
        idx = jax.lax.axis_index(axis)
        xr = xr.astype(jnp.float32)
        xi = xi.astype(jnp.float32)
        recv_r = jax.lax.ppermute(xr[:, n_local - (ntaps - 1):], axis, perm)
        recv_i = jax.lax.ppermute(xi[:, n_local - (ntaps - 1):], axis, perm)
        full_re = jnp.concatenate([jnp.where(idx == 0, hr, recv_r), xr], -1)
        full_im = jnp.concatenate([jnp.where(idx == 0, hi, recv_i), xi], -1)
        corr_sum, xmat = _fx_planar_core(full_re, full_im, taps_rm, m,
                                         ntaps, nout_local)
        corr_sum = jax.lax.psum(corr_sum, axis)
        fd = jnp.roll(corr_sum / (nout_local * d), m // 2, axis=-1)
        xre = jax.lax.psum(xmat.re, axis)
        xim = jax.lax.psum(xmat.im, axis)
        # shard 0 received the LAST shard's tail: the next step's history
        new_hr = jax.lax.psum(jnp.where(idx == 0, recv_r, 0.0), axis)
        new_hi = jax.lax.psum(jnp.where(idx == 0, recv_i, 0.0), axis)
        return fd, xre, xim, new_hr, new_hi

    x = jnp.zeros((a, n_local * d), in_dtype)
    hist = jnp.zeros((a, ntaps - 1), jnp.float32)
    return fn, (x, x, hist, hist)
