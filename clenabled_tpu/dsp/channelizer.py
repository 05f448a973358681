"""Polyphase filterbank channelizer.

Replaces clPolyphaseChannelizer (lib/clPolyphaseChannelizer_impl.cc): a
3-stage pipeline per frame (:84-109) —

  1. polyphase FIR with input commutator (kernel ``filterpfb2`` :156-167):
         acc[i,j] = sum_{k=j, k+=M} taps[k] * in[i*R + T-1 - k]
     written with the oversampling output rotation
         out[i, (j + i*(M-R)) % M] = acc[i,j]
     where M = num_channels, R = ninputs_per_iter (R ≤ M oversamples the
     output by M/R), T = ntaps;
  2. batched M-point reverse FFT, scale forced 1.0 (:208-225) → ifft·M;
  3. arbitrary output channel selection ``ch_map`` (kernel ``channel_map``
     :169-177).

Formulation: instead of one work-item per (sample, subfilter) scalar loop,
the commutator becomes a reshape of the input into M-sample blocks with
reversed lanes, and the branch filter W shifted elementwise multiply-adds
over the block axis — exact FLOPs, no gather, batched with the IFFT in one
jitted program.

History convention: the frame carries T-1 history samples at the front
(proper GR ``set_history(T)`` semantics; the reference buffer sizing
:98-101 under-allocates for R<M — we keep the correct bound).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _pfb_constants(taps, num_channels: int, ninputs_per_iter: int):
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    m, r = num_channels, ninputs_per_iter
    if r > m:
        raise ValueError("ninputs_per_iter must be <= num_channels")
    nbranch_taps = -(-ntaps // m)  # taps per branch, ceil
    padded = np.zeros(nbranch_taps * m, np.float32)
    padded[:ntaps] = taps
    # taps_rm[w, j] = taps[j + w*m]
    taps_rm = jnp.asarray(padded.reshape(nbranch_taps, m))
    return taps_rm, ntaps


def _branch_sums_critical(comp, taps_rm, m: int, t: int, nout: int):
    """Gather-free branch sums for the critically-sampled case (R == M).

    With idx = i·M + T-1 - j - w·M and taps padded to W·M, a global shift of
    δ = W·M - T zeros turns the commutator into a plain [nblk, M] reshape
    with reversed lanes, and the branch filter into W shifted elementwise
    MACs over the block axis (a depthwise conv) — elementwise code, no
    gather.
    comp: [T-1 + nout·M] float32 → [nout, M] float32.
    """
    w = taps_rm.shape[0]
    delta = w * m - t
    lp = jnp.zeros((delta,), comp.dtype)
    xp = jnp.concatenate([lp, comp])[: (nout + w - 1) * m]
    y = xp.reshape(nout + w - 1, m)[:, ::-1]
    hr = taps_rm[::-1]  # hr[w', j] = taps[j + (W-1-w')·M]
    acc = jnp.zeros((nout, m), comp.dtype)
    for wp in range(w):
        acc = acc + hr[wp] * jax.lax.dynamic_slice_in_dim(y, wp, nout, 0)
    return acc


def _pack_streams(comps, taps_rm, m: int, t: int, nout: int):
    """Lane-pack G parallel streams for the critically-sampled PFB.

    comps [G, T-1+nout·M] → (y [nout+W-1, G·M], hr [W, G·M]) such that
    acc[i, g·M+j] = Σ_wp hr[wp, g·M+j] · y[i+wp, g·M+j] equals the branch
    sums of stream g, subfilter j: one elementwise chain over all G
    streams instead of G narrow M-wide ones.
    """
    g = comps.shape[0]
    w = taps_rm.shape[0]
    delta = w * m - t
    lp = jnp.zeros((g, delta), comps.dtype)
    xp = jnp.concatenate([lp, comps], axis=-1)[:, : (nout + w - 1) * m]
    nblk = nout + w - 1
    y = xp.reshape(g, nblk, m)[..., ::-1]
    y = jnp.transpose(y, (1, 0, 2)).reshape(nblk, g * m)  # [nblk, G*M]
    hr = jnp.tile(taps_rm[::-1], (1, g))                   # [W, G*M]
    return y, hr


def _branch_sums_critical_batched(comps, taps_rm, m: int, t: int, nout: int):
    """Lane-packed branch sums for G parallel streams (e.g. antennas ×
    re/im): comps [G, T-1+nout·M] → [G, nout, M]."""
    g = comps.shape[0]
    w = taps_rm.shape[0]
    y, hr = _pack_streams(comps, taps_rm, m, t, nout)
    acc = jnp.zeros((nout, g * m), comps.dtype)
    for wp in range(w):
        acc = acc + hr[wp] * jax.lax.dynamic_slice_in_dim(y, wp, nout, 0)
    return jnp.transpose(acc.reshape(nout, g, m), (1, 0, 2))


def _branch_sums_gather(comp, taps_rm, gather_idx, nout: int, w: int, m: int):
    """General-R branch sums via explicit commutator gather (oversampled
    output)."""
    wr = jnp.take(comp, gather_idx, axis=-1).reshape(nout, w, m)
    return jnp.einsum("iwj,wj->ij", wr, taps_rm,
                      preferred_element_type=jnp.float32)


def _pfb_oversampled(comp, taps_rm, m: int, r: int, t: int, nout: int,
                     i_offset=0):
    """Gather-free oversampled (R < M) PFB for one float32 component,
    INCLUDING the output rotation.  comp: [T-1 + nout·R] → [nout, M].

    Output group i's commutator window starts at i·R; splitting outputs by
    phase p = i mod L with L = M/gcd(M,R) makes the within-phase stride
    L·R = lcm(M,R) — a whole number of M-sample blocks — so each phase is
    the critical-sampled shifted-MAC with a phase-specific lead shift.
    The oversampling rotation (j + i·(M−R)) mod M is constant within a
    phase (L·(M−R) ≡ 0 mod M), i.e. a static per-phase lane roll.  No
    gathers anywhere."""
    import math as _math

    w = taps_rm.shape[0]
    ell = m // _math.gcd(m, r)           # phases
    lp = (ell * r) // m                  # rows per within-phase step
    if nout % ell:
        raise ValueError(
            f"output count {nout} must be a multiple of M/gcd(M,R) = {ell}")
    nph = nout // ell
    hr = taps_rm[::-1]                   # hr[w', j] = taps[(W−1−w')·M + j]
    outs = []
    for p in range(ell):
        a_p = p * r + t - 1              # window start of phase p, u = 0
        delta = (m - 1 - a_p % m) + (w - 1) * m
        b0 = a_p // m                    # base row after the lead shift
        rows_total = (nph - 1) * lp + b0 + w
        need = rows_total * m
        pad_end = need - delta - comp.shape[-1]
        parts = [jnp.zeros((delta,), comp.dtype), comp]
        if pad_end > 0:
            parts.append(jnp.zeros((pad_end,), comp.dtype))
        zp = jnp.concatenate(parts)[:need]
        y = zp.reshape(rows_total, m)[:, ::-1]
        acc = jnp.zeros((nph, m), comp.dtype)
        for wp in range(w):
            rows = jax.lax.slice(y, (b0 + wp, 0),
                                 (b0 + wp + (nph - 1) * lp + 1, m), (lp, 1))
            acc = acc + hr[wp] * rows
        shift = jnp.mod((p + i_offset) * (m - r), m)
        outs.append(jnp.roll(acc, shift, axis=-1))
    # output i = p + L·u  →  interleave phases along a new axis 1
    return jnp.stack(outs, axis=1).reshape(nout, m)


@partial(jax.jit, static_argnames=("num_channels", "ninputs_per_iter", "ntaps"))
def _pfb_filter(x, taps_rm, i_offset=0, *, num_channels, ninputs_per_iter,
                ntaps):
    """x: [T-1 + buf_items] complex64 (history at front).
    Returns rotated subfilter outputs [nout, M] complex64.

    ``i_offset`` is the global output-group index of the first local group —
    the oversampling rotation phase is global, so time-sharded callers pass
    their shard's offset (sharding/halo.py)."""
    m, r, t = num_channels, ninputs_per_iter, ntaps
    buf_items = x.shape[-1] - (t - 1)
    nout = buf_items // r
    w = taps_rm.shape[0]
    del w
    if r == m:
        return (_branch_sums_critical(x.real.astype(jnp.float32), taps_rm,
                                      m, t, nout)
                + 1j * _branch_sums_critical(x.imag.astype(jnp.float32),
                                             taps_rm, m, t, nout)
                ).astype(jnp.complex64)
    # gather-free phase-split path (rotation included)
    return (_pfb_oversampled(x.real.astype(jnp.float32), taps_rm, m, r, t,
                             nout, i_offset)
            + 1j * _pfb_oversampled(x.imag.astype(jnp.float32), taps_rm, m,
                                    r, t, nout, i_offset)
            ).astype(jnp.complex64)


def _pfb_oversampled_planar(xre, xim, taps_rm, m: int, r: int, t: int,
                            nout: int, i_offset=0):
    """Packed planar variant of _pfb_oversampled: the 2·L (component ×
    phase) groups are packed side by side so one shifted-MAC chain covers
    2·L·M columns instead of M.  Returns (acc_re, acc_im) each [nout, M],
    rotation included."""
    import math as _math

    w = taps_rm.shape[0]
    ell = m // _math.gcd(m, r)
    lp = (ell * r) // m
    if nout % ell:
        raise ValueError(
            f"output count {nout} must be a multiple of M/gcd(M,R) = {ell}")
    nph = nout // ell
    b0 = [(p * r + t - 1) // m for p in range(ell)]
    b0max = max(b0)
    rows_total = (nph - 1) * lp + b0max + w
    need = rows_total * m
    groups = []
    for comp in (xre, xim):
        for p in range(ell):
            a_p = p * r + t - 1
            # extra lead rows align every phase's base row to b0max so the
            # packed MAC shares one slice offset per tap row
            delta = ((m - 1 - a_p % m) + (w - 1) * m
                     + (b0max - b0[p]) * m)
            parts = [jnp.zeros((delta,), comp.dtype), comp]
            pad_end = need - delta - comp.shape[-1]
            if pad_end > 0:
                parts.append(jnp.zeros((pad_end,), comp.dtype))
            groups.append(jnp.concatenate(parts)[:need])
    g = 2 * ell
    y = jnp.stack(groups).reshape(g, rows_total, m)[..., ::-1]
    y = jnp.transpose(y, (1, 0, 2)).reshape(rows_total, g * m)
    hr = jnp.tile(taps_rm[::-1], (1, g))
    acc = jnp.zeros((nph, g * m), xre.dtype)
    for wp in range(w):
        rows = jax.lax.slice(y, (b0max + wp, 0),
                             (b0max + wp + (nph - 1) * lp + 1, g * m),
                             (lp, 1))
        acc = acc + hr[wp] * rows
    acc = jnp.transpose(acc.reshape(nph, g, m), (1, 0, 2))  # [G, nph, M]
    outs = []
    for ci in range(2):
        phases = []
        for p in range(ell):
            shift = jnp.mod((p + i_offset) * (m - r), m)
            phases.append(jnp.roll(acc[ci * ell + p], shift, axis=-1))
        outs.append(jnp.stack(phases, axis=1).reshape(nout, m))
    return outs[0], outs[1]


@partial(jax.jit, static_argnames=("num_channels", "ninputs_per_iter", "ntaps"))
def _channelize(x, taps_rm, ch_map, i_offset=0, *, num_channels,
                ninputs_per_iter, ntaps):
    rotated = _pfb_filter(x, taps_rm, i_offset, num_channels=num_channels,
                          ninputs_per_iter=ninputs_per_iter, ntaps=ntaps)
    # batched reverse FFT, scale forced 1.0 (clFFT BACKWARD with scale=1)
    z = jnp.fft.ifft(rotated, axis=-1) * num_channels
    return z[:, ch_map].astype(jnp.complex64)


@partial(jax.jit, static_argnames=("num_channels", "ninputs_per_iter", "ntaps"))
def _channelize_planar(x, taps_rm, ch_map, i_offset=0, *, num_channels,
                       ninputs_per_iter, ntaps):
    """Planar-complex channelize: x is a planar.PC of [T-1+buf] streams.
    Same math as _channelize with the batched reverse FFT as an unscaled
    inverse DFT matmul (dsp.planar)."""
    from clenabled_tpu.dsp import planar

    m, r, t = num_channels, ninputs_per_iter, ntaps
    buf_items = x.re.shape[-1] - (t - 1)
    nout = buf_items // r
    w = taps_rm.shape[0]
    del w
    if r == m:
        acc = planar.PC(_branch_sums_critical(x.re, taps_rm, m, t, nout),
                        _branch_sums_critical(x.im, taps_rm, m, t, nout))
    else:
        # gather-free lane-packed phase-split path (rotation included)
        ar, ai = _pfb_oversampled_planar(x.re, x.im, taps_rm, m, r, t,
                                         nout, i_offset)
        acc = planar.PC(ar, ai)
    z = planar.ifft_unscaled(acc)  # reverse FFT, scale forced 1.0
    return planar.PC(z.re[:, ch_map], z.im[:, ch_map])


def polyphase_channelize(x, taps, num_channels: int, ninputs_per_iter: int,
                         ch_map):
    """One-shot: x [T-1 + buf_items] with history → [buf_items/R, len(ch_map)].

    buf_items must be a multiple of both num_channels (reference ctor check)
    and ninputs_per_iter.
    """
    taps_rm, ntaps = _pfb_constants(taps, num_channels, ninputs_per_iter)
    x = jnp.asarray(x, jnp.complex64)
    buf_items = x.shape[-1] - (ntaps - 1)
    if buf_items % num_channels:
        raise ValueError("buf_items must be a multiple of num_channels")
    if buf_items % ninputs_per_iter:
        raise ValueError("buf_items must be a multiple of ninputs_per_iter")
    ch_map = jnp.asarray(ch_map, jnp.int32)
    return _channelize(x, taps_rm, ch_map, num_channels=num_channels,
                       ninputs_per_iter=ninputs_per_iter, ntaps=ntaps)


def make_channelizer(taps, num_channels: int, ninputs_per_iter: int, ch_map,
                     planar: bool = False):
    """Streaming form: (init_state, apply); state = T-1 history samples.

    apply(history, frame[buf_items]) -> (history', out[buf_items/R, C]).
    With ``planar=True`` frames/outputs are planar.PC and the state is an
    (re, im) pair.
    """
    taps_rm, ntaps = _pfb_constants(taps, num_channels, ninputs_per_iter)
    ch_map_arr = jnp.asarray(ch_map, jnp.int32)

    if planar:
        from clenabled_tpu.dsp import planar as pl_mod

        def init_state(frame_size: int | None = None):
            del frame_size
            z = jnp.zeros((ntaps - 1,), jnp.float32)
            return (z, jnp.zeros_like(z))

        @jax.jit
        def apply(history, frame):
            fr = jnp.concatenate([history[0], frame.re], axis=-1)
            fi = jnp.concatenate([history[1], frame.im], axis=-1)
            out = _channelize_planar(
                pl_mod.PC(fr, fi), taps_rm, ch_map_arr,
                num_channels=num_channels,
                ninputs_per_iter=ninputs_per_iter, ntaps=ntaps)
            k = fr.shape[-1] - (ntaps - 1)
            return (fr[k:], fi[k:]), out

        return init_state, apply

    def init_state(frame_size: int | None = None):
        del frame_size
        return jnp.zeros((ntaps - 1,), jnp.complex64)

    @jax.jit
    def apply(history, frame):
        frame = jnp.asarray(frame, jnp.complex64)
        full = jnp.concatenate([history, frame], axis=-1)
        out = _channelize(full, taps_rm, ch_map_arr,
                          num_channels=num_channels,
                          ninputs_per_iter=ninputs_per_iter, ntaps=ntaps)
        new_hist = full[full.shape[-1] - (ntaps - 1):]
        return new_hist, out

    return init_state, apply
