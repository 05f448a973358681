"""Station-sharded X-Engine: all_to_all from station-sharding to
channel-sharding, then local per-channel Gram matmuls.

Capture is naturally station-sharded (each device ingests its antennas'
streams — the analogue of the reference's per-antenna input ports,
lib/clXEngine_impl.cc:88-90), but the cross-multiply needs ALL stations per
channel.  One ``all_to_all`` over the mesh axis re-shards [T, S/D, F, P] →
[T, S, F/D, P]; each device then owns the complete correlation output for its
channel slice — no further communication, and the integration state stays
channel-sharded on-device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from clenabled_tpu.dsp import xengine as dsp_xengine


def sharded_xengine(z, mesh: Mesh, axis: str = "shard", npol: int = 2,
                    output_format: int = dsp_xengine.CLXCORR_TRIANGULAR_ORDER):
    """One-shot correlate: z [T, S, F, P] station-sharded on dim 1 →
    output channel-sharded on dim 0 ([F, nb, npol²] or [F, SP, SP])."""
    d = mesh.shape[axis]
    z = jnp.asarray(z, jnp.complex64)
    t, s, f, p = z.shape
    if s % d or f % d:
        raise ValueError(f"stations ({s}) and channels ({f}) must divide mesh size {d}")

    @partial(jax.shard_map, mesh=mesh,
             in_specs=P(None, axis, None, None),
             out_specs=P(axis))
    def run(z_local):  # [T, S/D, F, P]
        # station-shard -> channel-shard: split channel dim, concat stations
        z_all = jax.lax.all_to_all(z_local, axis, split_axis=2, concat_axis=1,
                                   tiled=True)  # [T, S, F/D, P]
        return dsp_xengine.xengine_correlate(z_all, npol=npol,
                                             output_format=output_format)

    return run(z)


def make_sharded_xengine(num_inputs: int, num_channels: int, npol: int,
                         integration_time: int, mesh: Mesh,
                         axis: str = "shard",
                         output_format: int = dsp_xengine.CLXCORR_TRIANGULAR_ORDER,
                         pipeline_integration: int = 0):
    """Streaming form with channel-sharded accumulation state.

    apply(state, frames [T, S, F, P] station-sharded) →
    (state, (matrix channel-sharded, ready)).
    """
    d = mesh.shape[axis]
    if num_inputs % d or num_channels % d:
        raise ValueError("stations and channels must divide mesh size")
    nb = dsp_xengine.num_baselines(num_inputs)
    if output_format == dsp_xengine.CLXCORR_TRIANGULAR_ORDER:
        out_shape = (num_channels, nb, npol * npol)
    else:
        out_shape = (num_channels, num_inputs * npol, num_inputs * npol)
    pipe = max(1, pipeline_integration)

    def init_state():
        return (jnp.zeros(out_shape, jnp.complex64), jnp.zeros((), jnp.int32))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=((P(axis), P()), P(None, axis, None, None)),
             out_specs=((P(axis), P()), (P(axis), P())))
    def step(state, z_local):
        accum, count = state
        z_all = jax.lax.all_to_all(z_local, axis, split_axis=2, concat_axis=1,
                                   tiled=True)
        corr = dsp_xengine.xengine_correlate(z_all, npol=npol,
                                             output_format=output_format)
        accum, count, out, ready = dsp_xengine._pipeline_emit(
            accum, corr, count, pipe)
        return (accum, count), (out, ready)

    def apply(state, frames):
        frames = jnp.asarray(frames, jnp.complex64)
        if frames.shape != (integration_time, num_inputs, num_channels, npol):
            raise ValueError(
                f"frames shape {frames.shape} != "
                f"{(integration_time, num_inputs, num_channels, npol)}"
            )
        return step(state, frames)

    return init_state, apply


def make_sharded_xengine_stacked(num_inputs: int, num_channels: int,
                                 npol: int, integration_time: int,
                                 mesh: Mesh, axis: str = "shard",
                                 output_format: int =
                                 dsp_xengine.CLXCORR_TRIANGULAR_ORDER,
                                 pipeline_integration: int = 0,
                                 compute_dtype=None, scale: float = 1.0):
    """Multi-device stacked-Gram X-Engine: the single-matmul channel-major
    engine (dsp.xengine.xengine_correlate_stacked) over a station-sharded
    capture mesh.

    Capture is station-sharded: each device ingests its antennas'
    channelized planar streams as zr/zi [F, T, (S·P)/D] (float32/bfloat16/
    int8 — the IChar samples cross the interconnect as int8, quartering
    the all_to_all bytes).  One ``all_to_all`` re-shards to channel-sharded
    [F/D, T, S·P] (the Gram needs all stations per channel); each device
    then owns the
    complete correlation for its channel slice and the integration state
    stays channel-sharded on device (float32, exact int32 Gram per call
    for int8 ingest; ``scale`` e.g. 1/127² applied per call).

    apply(state, (zr, zi)) → (state', (planar.PC out channel-sharded on
    dim 0, ready)) with the reference's pipeline_integration emission
    contract (lib/clXEngine_impl.cc:289-292, :779-812)."""
    from clenabled_tpu.dsp import planar as pl_mod

    d = mesh.shape[axis]
    sp = num_inputs * npol
    if sp % d or num_channels % d:
        raise ValueError("stations·pols and channels must divide mesh size")
    nb = dsp_xengine.num_baselines(num_inputs)
    if output_format == dsp_xengine.CLXCORR_TRIANGULAR_ORDER:
        out_shape = (num_channels, nb, npol * npol)
    else:
        out_shape = (num_channels, sp, sp)
    pipe = max(1, pipeline_integration)
    expected = (num_channels, integration_time, sp)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(((P(axis), P(axis)), P()),
                       (P(None, None, axis), P(None, None, axis))),
             out_specs=(((P(axis), P(axis)), P()),
                        ((P(axis), P(axis)), P())))
    def step(state, frames):
        (acc_re, acc_im), count = state
        zr_local, zi_local = frames            # [F, T, SP/D]
        # lane-shard -> channel-shard: split channels, concat station lanes
        zr_all = jax.lax.all_to_all(zr_local, axis, split_axis=0,
                                    concat_axis=2, tiled=True)
        zi_all = jax.lax.all_to_all(zi_local, axis, split_axis=0,
                                    concat_axis=2, tiled=True)
        corr = dsp_xengine.xengine_correlate_stacked(
            zr_all, zi_all, npol=npol, output_format=output_format,
            compute_dtype=compute_dtype, scale=scale)
        (acc_re, acc_im), count, (out_re, out_im), ready = \
            dsp_xengine._pipeline_emit(
                (acc_re, acc_im), (corr.re, corr.im), count, pipe)
        return ((acc_re, acc_im), count), ((out_re, out_im), ready)

    def apply(state, frames):
        zr, zi = frames
        if zr.shape != expected:
            raise ValueError(f"frames shape {zr.shape} != {expected}")
        (acc, count) = state
        st = ((acc.re, acc.im), count)
        ((nre, nim), ncount), ((ore, oim), ready) = step(st, (zr, zi))
        return ((pl_mod.PC(nre, nim), ncount),
                (pl_mod.PC(ore, oim), ready))

    def init_state():
        return (pl_mod.zeros(out_shape), jnp.zeros((), jnp.int32))

    return init_state, apply
