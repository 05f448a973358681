"""X-Engine: xGPU-style FX interferometry correlator.

Replaces clXEngine (lib/clXEngine_impl.cc).  The reference integrates
``cxmac`` products with one work-item per (channel, baseline), each scalar-
looping over integration frames (:727-790).  Here the engine is the
per-channel Gram matrix: stacking station×pol spectra over time as
Z[t, s·p, f], the full correlation matrix is

    G[f, i, j] = sum_t Z[t, i, f] · conj(Z[t, j, f])

— a batched [SP, T] × [T, SP] matmul per channel (decomposed into real
matmuls that XLA hands to cuBLAS).  The triangular xGPU baseline order is
then a static gather:

    baseline k → station1 = floor(-0.5 + sqrt(0.25 + 2k)),
                 station2 = k - station1(station1+1)/2          (:744-750)

with per-baseline pol products [XX, XY, YX, YY] = z_{s1,p0}·conj(z_{s2,p1})
(cxmac is accum += z0·conj(z1), :736-743).

Input unpacking matches CharToComplex (:831-858): signed-byte I/Q scaled by
1/127, and packed 4-bit two's-complement pairs scaled by 1/7.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# output_format codes (lib/clXEngine_impl.h:28-29)
CLXCORR_TRIANGULAR_ORDER = 1
CLXCORR_FULL_MATRIX = 2


def num_baselines(num_inputs: int) -> int:
    """N(N+1)/2 including autocorrelations (lib/clXEngine_impl.cc:183)."""
    return num_inputs * (num_inputs + 1) // 2


def baseline_stations(num_inputs: int) -> np.ndarray:
    """[nbaselines, 2] int32 (station1, station2) in xGPU triangular order."""
    k = np.arange(num_baselines(num_inputs))
    s1 = np.floor(-0.5 + np.sqrt(0.25 + 2.0 * k)).astype(np.int32)
    s2 = (k - (s1 + 1) * s1 // 2).astype(np.int32)
    return np.stack([s1, s2], axis=-1)


def unpack_char(raw):
    """Interleaved signed-byte I/Q → complex64 · (1/127)."""
    f = jnp.asarray(raw, jnp.int8).astype(jnp.float32) * jnp.float32(1.0 / 127.0)
    pairs = f.reshape(f.shape[:-1] + (-1, 2))
    return (pairs[..., 0] + 1j * pairs[..., 1]).astype(jnp.complex64)


_TWOS_LUT = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0, -7, -6, -5, -4, -3, -2, -1],
                     dtype=np.float32)


def unpack_char_int8(raw):
    """Interleaved signed-byte I/Q → (re, im) int8 views, UNSCALED — the
    ingest for the int8 stacked engine (scale 1/127² applied once on
    the integer Gram result; exact, unlike the reference's per-sample
    1/127 float conversion, lib/clXEngine_impl.cc:831-845)."""
    b = jnp.asarray(raw, jnp.int8)
    pairs = b.reshape(b.shape[:-1] + (-1, 2))
    return pairs[..., 0], pairs[..., 1]


def _nib_signed(nib):
    """4-bit two's-complement nibble (int32 in [0, 15]) → signed value with
    the reference LUT's convention 0b1000 → 0 (lib/clXEngine_impl.cc
    _TWOS_LUT) — pure arithmetic+select, no table gather."""
    v = nib - ((nib & 8) << 1)           # standard sign extension (8 → −8)
    return jnp.where(nib == 8, 0, v)


def unpack_packed_4bit_int8(raw):
    """Packed 4-bit two's-complement I/Q → (re, im) int8, UNSCALED
    (values in [-7, 7]; scale 1/7² applied on the Gram result)."""
    b = jnp.asarray(raw, jnp.uint8).astype(jnp.int32)
    return (_nib_signed(b >> 4).astype(jnp.int8),
            _nib_signed(b & 0xF).astype(jnp.int8))


def unpack_char_planar(raw):
    """Interleaved signed-byte I/Q → planar.PC · (1/127) (complex-free)."""
    from clenabled_tpu.dsp import planar

    f = jnp.asarray(raw, jnp.int8).astype(jnp.float32) * jnp.float32(1.0 / 127.0)
    pairs = f.reshape(f.shape[:-1] + (-1, 2))
    return planar.PC(pairs[..., 0], pairs[..., 1])


def unpack_packed_4bit_planar(raw):
    """Packed 4-bit two's-complement I/Q → planar.PC · (1/7)."""
    from clenabled_tpu.dsp import planar

    b = jnp.asarray(raw, jnp.uint8).astype(jnp.int32)
    return planar.PC(
        _nib_signed(b >> 4).astype(jnp.float32) * jnp.float32(1.0 / 7.0),
        _nib_signed(b & 0xF).astype(jnp.float32) * jnp.float32(1.0 / 7.0))


def unpack_packed_4bit(raw):
    """Packed 4-bit two's-complement I/Q nibbles (high=I, low=Q) → complex64
    · (1/7).  One byte yields one complex sample; the reference handles the
    X/Y pol pair as consecutive bytes (uchar2, :846-855) which is just two
    consecutive samples here."""
    b = jnp.asarray(raw, jnp.uint8).astype(jnp.int32)
    i = _nib_signed(b >> 4).astype(jnp.float32) * jnp.float32(1.0 / 7.0)
    q = _nib_signed(b & 0xF).astype(jnp.float32) * jnp.float32(1.0 / 7.0)
    return (i + 1j * q).astype(jnp.complex64)


@partial(jax.jit, static_argnames=("num_inputs", "npol"))
def _gram(z, *, num_inputs: int, npol: int):
    """z: [T, S, F, P] complex64 → G: [F, S·P, S·P] complex64 via 4 real
    batched matmuls."""
    t, s, f, p = z.shape
    zz = jnp.transpose(z, (0, 1, 3, 2)).reshape(t, s * p, f)
    zr = zz.real.astype(jnp.float32)
    zi = zz.imag.astype(jnp.float32)
    # G[f,i,j] = sum_t z[t,i,f] conj(z[t,j,f])
    rr = jnp.einsum("tif,tjf->fij", zr, zr, preferred_element_type=jnp.float32)
    ii = jnp.einsum("tif,tjf->fij", zi, zi, preferred_element_type=jnp.float32)
    ri = jnp.einsum("tif,tjf->fij", zr, zi, preferred_element_type=jnp.float32)
    ir = jnp.einsum("tif,tjf->fij", zi, zr, preferred_element_type=jnp.float32)
    return ((rr + ii) + 1j * (ir - ri)).astype(jnp.complex64)


def xengine_correlate(z, npol: int = 2,
                      output_format: int = CLXCORR_TRIANGULAR_ORDER):
    """Correlate one integration window.

    Args:
      z: [T, S, F, P] complex64 — integration_time frames of station spectra
         (the reference marshals inputs into [time][station][chan][pol],
         lib/clXEngine_impl.cc:982-1061).
      npol: 1 or 2 polarizations.
      output_format: triangular xGPU order or the full matrix.

    Returns:
      triangular: [F, nbaselines, npol²] complex64 in xGPU order
        (pol products XX,XY,YX,YY for npol=2);
      full matrix: [F, S·npol, S·npol] complex64.
    """
    z = jnp.asarray(z, jnp.complex64)
    t, s, f, p = z.shape
    if p != npol:
        raise ValueError(f"input has {p} pols, expected {npol}")
    g = _gram(z, num_inputs=s, npol=p)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    rows, cols = _triangular_index(s, p)
    return g[:, rows, cols]               # [F, nb, p²]


def xengine_correlate_planar(z, npol: int = 2,
                             output_format: int = CLXCORR_TRIANGULAR_ORDER,
                             compute_dtype=None):
    """Planar-complex X-Engine: z is a planar.PC of [T, S, F, P].  Returns a
    planar.PC result — same math as xengine_correlate (which already
    decomposes into 4 real matmuls internally), with no complex64 anywhere.

    compute_dtype=jnp.bfloat16 runs the Gram matmuls with bf16 operands and
    float32 accumulation, which halves the operand bytes.  bf16×bf16
    products are exact and accumulate in f32, so for sample streams
    quantized to ≤8 bits (the reference's IChar/packed-4-bit ingest,
    lib/clXEngine_impl.cc:605-700) the result equals the f32 path
    (tests/test_xengine.py)."""
    from clenabled_tpu.dsp import planar

    t, s, f, p = z.re.shape
    if p != npol:
        raise ValueError(f"input has {p} pols, expected {npol}")
    zr = jnp.transpose(z.re, (0, 1, 3, 2)).reshape(t, s * p, f)
    zi = jnp.transpose(z.im, (0, 1, 3, 2)).reshape(t, s * p, f)
    if compute_dtype is not None:
        zr = zr.astype(compute_dtype)
        zi = zi.astype(compute_dtype)
    rr = jnp.einsum("tif,tjf->fij", zr, zr, preferred_element_type=jnp.float32)
    ii = jnp.einsum("tif,tjf->fij", zi, zi, preferred_element_type=jnp.float32)
    ri = jnp.einsum("tif,tjf->fij", zr, zi, preferred_element_type=jnp.float32)
    ir = jnp.einsum("tif,tjf->fij", zi, zr, preferred_element_type=jnp.float32)
    g = planar.PC(rr + ii, ir - ri)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    rows, cols = _triangular_index(s, p)
    return planar.PC(g.re[:, rows, cols], g.im[:, rows, cols])


def xengine_correlate_channel_major(zr, zi, npol: int = 2,
                                    output_format: int = CLXCORR_TRIANGULAR_ORDER,
                                    compute_dtype=None):
    """Channel-major planar X-Engine: zr/zi are [F, T, S·P] float32 or
    bfloat16 (channels batched outermost, stations·pols innermost).  With
    this layout the Gram contraction needs no transposes; with
    compute_dtype=bfloat16 it is exact for ≤8-bit quantized streams.

    The reference marshals [time][station][chan][pol]
    (lib/clXEngine_impl.cc:982-1061) because its GPU kernel wants
    baseline-parallel work items; a batched matmul wants the channel batch
    outermost.  Returns the same planar triangular/full-matrix output as
    xengine_correlate_planar.
    """
    from clenabled_tpu.dsp import planar

    f, t, sp = zr.shape
    s = sp // npol
    if compute_dtype is not None:
        zr = zr.astype(compute_dtype)
        zi = zi.astype(compute_dtype)
    rr = jnp.einsum("ftk,ftl->fkl", zr, zr, preferred_element_type=jnp.float32)
    ii = jnp.einsum("ftk,ftl->fkl", zi, zi, preferred_element_type=jnp.float32)
    ri = jnp.einsum("ftk,ftl->fkl", zr, zi, preferred_element_type=jnp.float32)
    ir = jnp.einsum("ftk,ftl->fkl", zi, zr, preferred_element_type=jnp.float32)
    g = planar.PC(rr + ii, ir - ri)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    rows, cols = _triangular_index(s, npol)
    return planar.PC(g.re[:, rows, cols], g.im[:, rows, cols])


def _triangular_index(s: int, npol: int):
    """[nb, npol²] (row, col) indices extracting the xGPU triangular order
    (pol products XX,XY,YX,YY) from a full [S·P, S·P] Gram matrix."""
    st = baseline_stations(s)
    s1, s2 = jnp.asarray(st[:, 0]), jnp.asarray(st[:, 1])
    p0 = jnp.arange(npol).repeat(npol)
    p1 = jnp.tile(jnp.arange(npol), npol)
    rows = s1[:, None] * npol + p0[None, :]
    cols = s2[:, None] * npol + p1[None, :]
    return rows, cols


def _pipeline_emit(accum, corr, count, pipe: int):
    """Shared pipeline-integration state machine: accumulate on device and
    emit every ``pipe`` calls, zeros in between (the reference's '+='
    kernels + enqueueFillBuffer zeroing, lib/clXEngine_impl.cc:289-292,
    :779-812).  accum/corr are matching pytrees of arrays.

    Returns (new_accum, new_count, out, ready)."""
    accum = jax.tree.map(jnp.add, accum, corr)
    count = count + 1
    ready = count >= pipe
    zeros = jax.tree.map(jnp.zeros_like, accum)
    out = jax.tree.map(lambda a, z: jnp.where(ready, a, z), accum, zeros)
    new_accum = jax.tree.map(lambda a, z: jnp.where(ready, z, a),
                             accum, zeros)
    return new_accum, jnp.where(ready, jnp.int32(0), count), out, ready


def xengine_gram_stacked(zr, zi):
    """Full per-channel Gram of channel-major planar spectra as ONE
    stacked matmul: zr/zi [F, T, S·P] → (gr, gi) [F, S·P, S·P] with
    G = Σ_t z·conj(z)ᵀ.  Stacking W = [zr | zi] along the last axis
    computes the four real blocks rr, ri, ir, ii in a single einsum
    G2 = Wᵀ·W per channel, so the operands are read once.

    int8 operands (the reference's IChar samples, lib/clXEngine_impl.cc
    :605-700, used RAW without the 1/127 scaling) accumulate in int32 and
    the result is integer-exact (|G| ≤ 2·T·127², exact for T < 66,000);
    float operands accumulate in float32."""
    sp = zr.shape[-1]
    w = jnp.concatenate([zr, zi], axis=-1)            # [F, T, 2·SP]
    acc_t = (jnp.int32 if jnp.issubdtype(zr.dtype, jnp.integer)
             else jnp.float32)
    g2 = jnp.einsum("ftk,ftl->fkl", w, w, preferred_element_type=acc_t)
    rr = g2[:, :sp, :sp]
    ri = g2[:, :sp, sp:]
    ir = g2[:, sp:, :sp]
    ii = g2[:, sp:, sp:]
    return rr + ii, ir - ri


def xengine_correlate_stacked(zr, zi, npol: int = 2,
                              output_format: int = CLXCORR_TRIANGULAR_ORDER,
                              compute_dtype=None, scale: float = 1.0):
    """Channel-major X-Engine on the stacked Gram (xengine_gram_stacked).

    zr/zi: [F, T, S·P] float32/bfloat16/int8.  ``scale`` (e.g. 1/127² for
    raw IChar samples) is applied once on the result.  bfloat16 is exact
    for ≤8-bit quantized streams.  Returns planar.PC float32, triangular
    xGPU order or full matrix."""
    from clenabled_tpu.dsp import planar

    s = zr.shape[-1] // npol
    if compute_dtype is not None:
        zr = zr.astype(compute_dtype)
        zi = zi.astype(compute_dtype)
    gr, gi = xengine_gram_stacked(zr, zi)
    gr = gr.astype(jnp.float32)
    gi = gi.astype(jnp.float32)
    if scale != 1.0:
        gr = gr * jnp.float32(scale)
        gi = gi * jnp.float32(scale)
    g = planar.PC(gr, gi)
    if output_format == CLXCORR_FULL_MATRIX:
        return g
    rows, cols = _triangular_index(s, npol)
    return planar.PC(g.re[:, rows, cols], g.im[:, rows, cols])


def make_xengine_channel_major(num_inputs: int, num_channels: int, npol: int,
                               integration_time: int,
                               output_format: int = CLXCORR_TRIANGULAR_ORDER,
                               pipeline_integration: int = 0,
                               compute_dtype=None, scale: float = 1.0):
    """Streaming channel-major X-Engine (the batched-matmul marshal order) with
    GPU-side pipeline integration — the channel-major analogue of
    make_xengine.

    apply(state, (zr, zi)) with zr/zi [F, T, S·P] (float32/bf16/int8)
    returns (state', (out planar.PC, ready)): the per-call correlation is
    accumulated on device (float32, after int32→f32 conversion for int8
    ingest — one integration stays exact in int32, T·127²·2 < 2³¹ for
    T ≤ 65k) and emitted every ``pipeline_integration`` calls, zeros in
    between (the reference's '+=' kernels + enqueueFillBuffer,
    lib/clXEngine_impl.cc:289-292, :779-812)."""
    if npol not in (1, 2):
        raise ValueError("npol must be 1 or 2")
    nb = num_baselines(num_inputs)
    if output_format == CLXCORR_TRIANGULAR_ORDER:
        out_shape = (num_channels, nb, npol * npol)
    else:
        out_shape = (num_channels, num_inputs * npol,
                     num_inputs * npol)
    pipe = max(1, pipeline_integration)
    expected = (num_channels, integration_time, num_inputs * npol)

    from clenabled_tpu.dsp import planar as pl_mod

    def init_state() -> XEngineState:
        return XEngineState(accum=pl_mod.zeros(out_shape),
                            count=jnp.int32(0))

    @jax.jit
    def apply(state: XEngineState, frames):
        zr, zi = frames
        if zr.shape != expected:
            raise ValueError(f"frames shape {zr.shape} != {expected}")
        corr = xengine_correlate_stacked(zr, zi, npol=npol,
                                         output_format=output_format,
                                         compute_dtype=compute_dtype,
                                         scale=scale)
        accum, count, out, ready = _pipeline_emit(
            state.accum, corr, state.count, pipe)
        return XEngineState(accum=accum, count=count), (out, ready)

    return init_state, apply


class XEngineState(NamedTuple):
    """On-device accumulation state for pipeline integration — the role of
    the reference's GPU-side '+=' kernels + enqueueFillBuffer zeroing
    (lib/clXEngine_impl.cc:289-292, :779-812)."""
    accum: jax.Array        # same shape as one correlate() output
    count: jax.Array        # int32 integrations accumulated


def make_xengine(num_inputs: int, num_channels: int, npol: int,
                 integration_time: int,
                 output_format: int = CLXCORR_TRIANGULAR_ORDER,
                 pipeline_integration: int = 0,
                 planar: bool = False):
    """Streaming X-Engine: (init_state, apply).

    apply(state, frames) with frames [integration_time, S, F, P] returns
    (state', out_or_None-like): when pipeline_integration ≤ 1, out is the
    correlation each call; otherwise out is the accumulated matrix emitted
    every ``pipeline_integration`` calls (zeros and a ``ready`` flag in
    between — XLA needs static shapes, so out is always produced alongside
    state.ready).
    """
    if npol not in (1, 2):
        raise ValueError("npol must be 1 or 2")
    nb = num_baselines(num_inputs)
    if output_format == CLXCORR_TRIANGULAR_ORDER:
        out_shape = (num_channels, nb, npol * npol)
    else:
        out_shape = (num_channels, num_inputs * npol, num_inputs * npol)
    pipe = max(1, pipeline_integration)
    expected = (integration_time, num_inputs, num_channels, npol)

    if planar:
        from clenabled_tpu.dsp import planar as pl_mod

        def init_state() -> XEngineState:
            return XEngineState(
                accum=pl_mod.zeros(out_shape),
                count=jnp.int32(0),
            )

        @jax.jit
        def apply(state: XEngineState, frames):
            if frames.re.shape != expected:
                raise ValueError(
                    f"frames shape {frames.re.shape} != {expected}")
            corr = xengine_correlate_planar(frames, npol=npol,
                                            output_format=output_format)
            accum, count, out, ready = _pipeline_emit(
                state.accum, corr, state.count, pipe)
            return XEngineState(accum=accum, count=count), (out, ready)

        return init_state, apply

    def init_state() -> XEngineState:
        return XEngineState(
            accum=jnp.zeros(out_shape, jnp.complex64),
            count=jnp.int32(0),
        )

    @jax.jit
    def apply(state: XEngineState, frames):
        if frames.shape != expected:
            raise ValueError(
                f"frames shape {frames.shape} != {expected}"
            )
        corr = xengine_correlate(frames, npol=npol, output_format=output_format)
        accum, count, out, ready = _pipeline_emit(
            state.accum, corr, state.count, pipe)
        return XEngineState(accum=accum, count=count), (out, ready)

    return init_state, apply
