"""Planar (complex-free) time-sharded filtering.

Same ring-ppermute halo design as sharding/halo.py, with streams and state
as (re, im) float32 pairs.  shard_map specs follow the planar.PC pytree
structure.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from clenabled_tpu.dsp import fft_filter as dsp_ofa
from clenabled_tpu.dsp import planar


def _ring_fwd(n: int):
    return [(j, (j + 1) % n) for j in range(n)]


def make_sharded_fft_filter_planar(taps, mesh: Mesh, axis: str = "shard",
                                   decimation: int = 1):
    """Planar fast-convolution filter across time-shards: overlap-add per
    shard with the additive output-tail halo (shard j adds shard j−1's
    tail; shard 0 the carried state).

    apply(state, x: PC[D·L]) → (state, y: PC); per-shard block must be a
    multiple of the plan's nsamples and of ``decimation``."""
    plan = dsp_ofa.plan_fft_filter(taps, decimation=1)
    k = plan.ntaps
    d = mesh.shape[axis]
    perm = _ring_fwd(d)
    taps_r = jnp.asarray(plan.xformed_taps.real.copy(), jnp.float32)
    taps_i = jnp.asarray(plan.xformed_taps.imag.copy(), jnp.float32)

    def init_state():
        z = jnp.zeros((d, k - 1), jnp.float32)
        return (z, jnp.zeros_like(z))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=((P(axis, None), P(axis, None)),
                       planar.PC(P(axis), P(axis))),
             out_specs=((P(axis, None), P(axis, None)),
                        planar.PC(P(axis), P(axis))))
    def step(state, x):
        idx = jax.lax.axis_index(axis)
        zr = jnp.zeros(k - 1, jnp.float32)
        yr, yi, tr, ti = dsp_ofa._ofa_filter_planar(
            x.re, x.im, zr, zr, taps_r, taps_i,
            nsamples=plan.nsamples, fftsize=plan.fftsize, ntaps=k,
            decimation=1)
        recv_r = jax.lax.ppermute(tr, axis, perm)
        recv_i = jax.lax.ppermute(ti, axis, perm)
        halo_r = jnp.where(idx == 0, state[0][0], recv_r)
        halo_i = jnp.where(idx == 0, state[1][0], recv_i)
        yr = yr.at[: k - 1].add(halo_r)
        yi = yi.at[: k - 1].add(halo_i)
        new_state = (jnp.where(idx == 0, recv_r, state[0][0])[None],
                     jnp.where(idx == 0, recv_i, state[1][0])[None])
        if decimation > 1:
            yr, yi = yr[::decimation], yi[::decimation]
        return new_state, planar.PC(yr, yi)

    def apply(state, x):
        local = x.re.shape[-1] // d
        if local % plan.nsamples or local % decimation:
            raise ValueError(
                f"per-shard block {local} must be a multiple of nsamples="
                f"{plan.nsamples} and decimation={decimation}")
        return step(state, x)

    return init_state, apply


def make_sharded_channelizer_planar(taps, num_channels: int,
                                    ninputs_per_iter: int, ch_map,
                                    mesh: Mesh, axis: str = "shard"):
    """Planar time-sharded PFB channelizer (complex-free multi-device path):
    input halo = ntaps-1 samples via ring ppermute on both components.
    apply(state, x: PC[D·L]) → (state, out: PC[D·L/R, C])."""
    from clenabled_tpu.dsp import channelizer as dsp_chan

    taps_rm, ntaps = dsp_chan._pfb_constants(taps, num_channels,
                                             ninputs_per_iter)
    ch_arr = jnp.asarray(ch_map, jnp.int32)
    d = mesh.shape[axis]
    perm = _ring_fwd(d)

    def init_state():
        z = jnp.zeros((d, ntaps - 1), jnp.float32)
        return (z, jnp.zeros_like(z))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=((P(axis, None), P(axis, None)),
                       planar.PC(P(axis), P(axis))),
             out_specs=((P(axis, None), P(axis, None)),
                        planar.PC(P(axis, None), P(axis, None))))
    def step(state, x):
        idx = jax.lax.axis_index(axis)
        recv_r = jax.lax.ppermute(x.re[-(ntaps - 1):], axis, perm)
        recv_i = jax.lax.ppermute(x.im[-(ntaps - 1):], axis, perm)
        halo_r = jnp.where(idx == 0, state[0][0], recv_r)
        halo_i = jnp.where(idx == 0, state[1][0], recv_i)
        full = planar.PC(jnp.concatenate([halo_r, x.re]),
                         jnp.concatenate([halo_i, x.im]))
        i_offset = idx * (x.re.shape[-1] // ninputs_per_iter)
        out = dsp_chan._channelize_planar(
            full, taps_rm, ch_arr, i_offset, num_channels=num_channels,
            ninputs_per_iter=ninputs_per_iter, ntaps=ntaps)
        new_state = (jnp.where(idx == 0, recv_r, state[0][0])[None],
                     jnp.where(idx == 0, recv_i, state[1][0])[None])
        return new_state, out

    def apply(state, x):
        local = x.re.shape[-1] // d
        if local % ninputs_per_iter or local % num_channels:
            raise ValueError(
                f"per-shard block {local} must be a multiple of "
                f"num_channels={num_channels} and R={ninputs_per_iter}")
        return step(state, x)

    return init_state, apply


def sharded_xengine_planar(z, mesh: Mesh, axis: str = "shard", npol: int = 2):
    """Planar station-sharded X-Engine: z PC[T, S, F, P] station-sharded →
    channel-sharded triangular PC output (all_to_all on both components)."""
    from clenabled_tpu.dsp import xengine as dsp_xengine

    d = mesh.shape[axis]
    t, s, f, p = z.re.shape
    if s % d or f % d:
        raise ValueError(
            f"stations ({s}) and channels ({f}) must divide mesh size {d}")

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(planar.PC(P(None, axis, None, None),
                                 P(None, axis, None, None)),),
             out_specs=planar.PC(P(axis), P(axis)))
    def run(z_local):
        zr = jax.lax.all_to_all(z_local.re, axis, split_axis=2, concat_axis=1,
                                tiled=True)
        zi = jax.lax.all_to_all(z_local.im, axis, split_axis=2, concat_axis=1,
                                tiled=True)
        return dsp_xengine.xengine_correlate_planar(planar.PC(zr, zi),
                                                    npol=npol)

    return run(z)


def make_sharded_costas_channels(loop_bw: float, order: int, mesh: Mesh,
                                 axis: str = "shard", chunk: int = 1024,
                                 warmup: int = 512,
                                 exact_fallback_residual: float | None = None):
    """CHANNEL-parallel chunked Costas loops across the mesh: C independent
    streams (e.g. the channelizer's outputs) sharded over devices, each
    running the speculative chunk-parallel loop (dsp.demod.
    make_costas_loop_chunked) locally — no cross-chip communication in the
    hot path, the natural multi-chip shape for per-sample feedback DSP.

    apply(state, x: PC[C, n]) → (state, out: PC[C, n], diag) with diag
    arrays per channel ("residual", "exact", "branch_hops", "fell_back").
    C must be a multiple of the mesh axis size.
    """
    from clenabled_tpu.dsp import demod

    run = demod.make_costas_loop_chunked(
        loop_bw, order, chunk=chunk, warmup=warmup,
        exact_fallback_residual=exact_fallback_residual)
    d = mesh.shape[axis]

    def init_state(num_channels: int):
        if num_channels % d:
            raise ValueError(f"channels {num_channels} not a multiple of "
                             f"mesh size {d}")
        z = jnp.zeros((num_channels,), jnp.float32)
        w = jnp.zeros((num_channels, warmup), jnp.float32)
        return (demod.CostasState(phase=z, freq=z, error=z),
                planar.PC(w, jnp.zeros_like(w)))

    vrun = jax.vmap(lambda lag, tail, fr: run((lag, tail), fr))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=((demod.CostasState(P(axis), P(axis), P(axis)),
                        planar.PC(P(axis, None), P(axis, None))),
                       planar.PC(P(axis, None), P(axis, None))),
             out_specs=((demod.CostasState(P(axis), P(axis), P(axis)),
                         planar.PC(P(axis, None), P(axis, None))),
                        planar.PC(P(axis, None), P(axis, None)),
                        {"branch_hops": P(axis), "exact": P(axis),
                         "fell_back": P(axis), "residual": P(axis)}))
    def step(state, x):
        lag, tail = state
        (nlag, ntail), out, diag = vrun(lag, tail, x)
        return (nlag, ntail), out, diag

    def apply(state, x):
        return step(state, x)

    return init_state, apply
