"""Window-parallel sharded cross-correlators.

The TD lag scan and FD conj-mult correlators are per-analysis-window
computations with no carried state (the reference runs one window per
work() call, lib/clXCorrelate_impl.cc:843-903 /
clxcorrelate_fft_vcf_impl.cc:886-937) — so the natural multi-chip shape is
plain data parallelism: shard the WINDOW batch axis over the mesh and run
the single-chip planar kernels per shard, zero collectives in the hot
path.  A final psum-free gather only happens if the caller asks for host
results; the sharded outputs stay sharded for downstream sharded blocks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from clenabled_tpu.dsp import planar, xcorr


def make_sharded_td_xcorr(mesh: Mesh, max_shift: int, axis: str = "shard"):
    """Batch-sharded TD lag scan: mags [nsignals, B, n] float32 with the
    window axis B sharded over the mesh; each chip runs the planar
    normalized lag scan (dsp.xcorr.td_xcorr_planar_batched) on its B/D
    windows.  Returns apply(mags) -> XCorrResult with leading
    [nsignals-1, B] dims, B sharded.

    B must be a multiple of the mesh axis size.  Complex streams: take
    planar.pabs first (the reference's magnitude pre-pass,
    lib/clXCorrelate_impl.cc:1483-1489).
    """
    d = mesh.shape[axis]

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(None, axis, None),),
             out_specs=xcorr.XCorrResult(
                 corr=P(None, axis), lag=P(None, axis),
                 corr_vectors=P(None, axis, None)))
    def apply(mags):
        return xcorr.td_xcorr_planar_batched(mags, max_shift)

    def checked(mags):
        if mags.shape[1] % d:
            raise ValueError(
                f"window batch {mags.shape[1]} must be a multiple of the "
                f"mesh axis size {d}")
        return apply(mags)

    return checked


def make_sharded_fd_xcorr(mesh: Mesh, axis: str = "shard",
                          perform_fft_first: bool = False):
    """Batch-sharded FD correlator: vectors planar.PC [nsignals, B,
    fft_size] with B sharded; per shard the planar conj-mult → unscaled
    inverse DFT → magnitude → half-swap (dsp.xcorr.fd_xcorr_planar,
    reference semantics lib/clxcorrelate_fft_vcf_impl.cc:886-937,
    1131-1141; input_type=2 via perform_fft_first).  Returns
    apply(vectors) -> [nsignals-1, B, fft_size] float32, B sharded."""
    d = mesh.shape[axis]

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(planar.PC(P(None, axis, None), P(None, axis, None)),),
             out_specs=P(None, axis, None))
    def apply(v):
        return xcorr.fd_xcorr_planar(v, perform_fft_first=perform_fft_first)

    def checked(v):
        if v.re.shape[1] % d:
            raise ValueError(
                f"window batch {v.re.shape[1]} must be a multiple of the "
                f"mesh axis size {d}")
        return apply(v)

    return checked
