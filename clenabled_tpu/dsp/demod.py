"""Demodulators: quadrature (FM/FSK) demod and the Costas loop.

- ``quadrature_demod`` replaces clQuadratureDemod
  (lib/clQuadratureDemod_impl.cc:108-181): out[i] = gain·arg(x[i+1]·conj(x[i]))
  with one sample of history carried between frames (set_history(2), :81).
- ``costas_loop`` replaces clCostasLoop (lib/clCostasLoop_impl.cc:151-312).
  The reference runs the feedback loop as a SINGLE-work-item GPU kernel
  (~0.7 MSPS, README.md:64) because it is inherently sequential.  Here the
  exact form is a `lax.scan` carrying (phase, freq): same recurrence,
  compiler-scheduled, and the carried state is an explicit NamedTuple instead
  of three single-element device buffers (:318-366).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

TWO_PI = 2.0 * math.pi


def quadrature_demod(x, gain: float, last_sample=None):
    """FM discriminator over a frame.

    Args:
      x: [n] complex64 frame.
      gain: demod gain (baked as #define GAIN in the reference kernel).
      last_sample: carried x[-1] of the previous frame (None → first frame
        behaves as if preceded by x[0], producing 0 for the first output).

    Returns: (y, new_last_sample) with y: [n] float32.
    """
    x = jnp.asarray(x, jnp.complex64)
    if last_sample is None:
        last_sample = x[..., :1]
    prev = jnp.concatenate([last_sample, x[..., :-1]], axis=-1)
    prod = x * jnp.conj(prev)
    y = (jnp.float32(gain) * jnp.arctan2(prod.imag, prod.real)).astype(jnp.float32)
    return y, x[..., -1:]


def quadrature_demod_planar(x, gain: float, last_sample=None):
    """Planar quadrature demod: x is a planar.PC frame; identical math
    (gain·atan2 of x[i]·conj(x[i-1])).  The one-sample shift is computed
    on sliced views with an output-side concat, so no shifted copy of the
    input is materialized."""
    from clenabled_tpu.dsp import planar

    if last_sample is None:
        last_sample = planar.PC(x.re[..., :1], x.im[..., :1])
    xr, xi = x.re, x.im
    lr, li = last_sample.re, last_sample.im
    pr_b, pi_b = xr[..., :-1], xi[..., :-1]
    cr = xr[..., 1:] * pr_b + xi[..., 1:] * pi_b
    ci = xi[..., 1:] * pr_b - xr[..., 1:] * pi_b
    ybody = jnp.float32(gain) * jnp.arctan2(ci, cr)
    c0r = xr[..., :1] * lr + xi[..., :1] * li
    c0i = xi[..., :1] * lr - xr[..., :1] * li
    y0 = jnp.float32(gain) * jnp.arctan2(c0i, c0r)
    y = jnp.concatenate([y0, ybody], axis=-1).astype(jnp.float32)
    return y, planar.PC(x.re[..., -1:], x.im[..., -1:])


class CostasState(NamedTuple):
    """phase/freq/error — the reference's persistent device buffers."""
    phase: jax.Array
    freq: jax.Array
    error: jax.Array


def costas_init() -> CostasState:
    return CostasState(phase=jnp.float32(0.0), freq=jnp.float32(0.0),
                       error=jnp.float32(0.0))


def costas_gains(loop_bw: float) -> tuple[float, float]:
    """alpha/beta from loop bandwidth, per GR blocks::control_loop
    (critically damped 2nd-order loop; the reference bakes these as
    #defines, lib/clCostasLoop_impl.cc:134-137)."""
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4.0 * damping * loop_bw) / denom
    beta = (4.0 * loop_bw * loop_bw) / denom
    return alpha, beta


def make_costas_loop_planar(loop_bw: float, order: int,
                            max_freq: float = 1.0, min_freq: float = -1.0):
    """Planar Costas loop: frames and outputs are planar.PC; the scan body
    runs entirely in float32 (sin/cos NCO on real parts)."""
    from clenabled_tpu.dsp import planar

    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    alpha, beta = costas_gains(loop_bw)
    step = _costas_step_planar(order, jnp.float32(alpha), jnp.float32(beta),
                               jnp.float32(min_freq), jnp.float32(max_freq))

    @jax.jit
    def run(state: CostasState, frame):
        # unroll amortizes the per-iteration loop overhead
        (phase, freq, error), (o_r, o_i) = jax.lax.scan(
            step, (state.phase, state.freq, state.error),
            (frame.re, frame.im), unroll=16
        )
        return (CostasState(phase=phase, freq=freq, error=error),
                planar.PC(o_r, o_i))

    return run


def _costas_step_planar(order: int, alpha, beta, f_min, f_max):
    """The per-sample recurrence (shared by scan/vmap/chunked forms)."""

    def step(carry, sample):
        phase, freq, _ = carry
        s_r, s_i = sample
        n_r = jnp.cos(-phase)
        n_i = jnp.sin(-phase)
        o_r = s_r * n_r - s_i * n_i
        o_i = s_r * n_i + s_i * n_r
        if order == 2:
            error = o_r * o_i
        else:
            error = (jnp.where(o_r > 0, 1.0, -1.0) * o_i
                     - jnp.where(o_i > 0, 1.0, -1.0) * o_r)
        error = 0.5 * (jnp.abs(error + 1.0) - jnp.abs(error - 1.0))
        freq = freq + beta * error
        phase = phase + freq + alpha * error
        phase = jnp.where(
            (phase > TWO_PI) | (phase < -TWO_PI),
            (phase / TWO_PI - jnp.trunc(phase / TWO_PI)) * TWO_PI,
            phase,
        )
        freq = jnp.clip(freq, f_min, f_max)
        return (phase, freq, error), (o_r, o_i)

    return step


def make_costas_loop_chunked(loop_bw: float, order: int,
                             max_freq: float = 1.0, min_freq: float = -1.0,
                             chunk: int = 8192, warmup: int = 1024,
                             unroll: int = 16,
                             exact_fallback_residual: float | None = None):
    """Speculative chunk-parallel Costas loop with an EXACTNESS certificate.

    A single per-sample feedback chain is latency-bound on any hardware
    (the reference's single-work-item GPU kernel manages ~0.7 MSPS,
    README.md:64).  But a locked 2nd-order loop is strongly
    CONTRACTING: trajectories from different initial states converge — in
    float32, to bitwise identity — within a few loop time constants.  So:

    * split the frame into ``chunk``-sample chunks processed in PARALLEL
      (vmap — many loops run for the price of one);
    * each chunk warm-starts ``warmup`` samples early from a guess
      (phase 0, the carried frequency estimate) and discards the warm-up
      outputs;
    * chunk 0 warm-starts from the EXACTLY carried (state, tail) pair, so
      it is unconditionally exact;
    * certificate: the seam deltas (chunk c's warm-up-end state vs chunk
      c−1's final state) are computed in the same pass.  ``residual``
      bounds the trajectory deviation: locked streams measure 1-4 float32
      ulps (modulated inputs keep neighboring trajectories inside a
      rounding-dither limit cycle, so bitwise merging — reported as
      ``exact`` — only happens for especially stable signals).

    The loop's discrete phase ambiguity (π for order 2 — BPSK; π/2 for
    order 4) means a chunk may lock a branch away from its neighbor; the
    seam deltas detect the branch hop (a multiple of κ) and the outputs
    are corrected by the cumulative branch EXACTLY (sign flips/quadrant
    swaps, no float rotation).  When the bitwise certificate fails but
    ``residual`` is small, outputs are a branch-coherent locked trajectory
    within float dither of the sequential one; re-run the sequential form
    if bit-exactness is required.

    ACQUISITION behavior (tests/test_costas_acquisition): before lock the
    loop is NOT
    contracting, so chunks warm-started from the frequency prediction can
    diverge from the sequential trajectory — the certificate reports
    exactly this (``residual`` jumps orders of magnitude above the locked
    1e-7-class).  Cold starts typically certify from the second frame on;
    a mid-stream phase/frequency step shows one high-residual frame and
    re-certifies once re-locked.  Policy options, strictest first:

    * ``exact_fallback_residual=r``: frames whose residual exceeds ``r``
      are RE-RUN through the exact sequential recurrence inside the same
      jitted call (lax.cond — the fallback executes only when triggered,
      costing the sequential latency for that frame only).  Output is then
      bit-identical to the sequential form whenever the certificate is
      suspect: the speculative path is a pure accelerator.
    * watch ``residual``/``exact`` in the diag dict (the CostasLoop
      block's "lock" message port) and treat high-residual frames as
      unlocked — the right semantics for burst acquisition, where the
      pre-lock transient is garbage in ANY implementation.

    Returns run(state, frame: planar.PC) -> (state', out: planar.PC,
    diag dict with ``exact`` (bitwise certificate), ``residual`` (max seam
    deviation after branch removal), ``branch_hops``, ``fell_back``).
    State = (CostasState at frame_start − warmup, tail planar.PC of the
    last ``warmup`` samples).  Frame length must be a positive multiple of
    ``chunk``; warmup ≤ chunk.
    """
    from clenabled_tpu.dsp import planar

    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    if warmup > chunk:
        raise ValueError("warmup must be <= chunk")
    alpha, beta = costas_gains(loop_bw)
    step = _costas_step_planar(order, jnp.float32(alpha), jnp.float32(beta),
                               jnp.float32(min_freq), jnp.float32(max_freq))
    w, c = warmup, chunk

    def chunk_run(start, win_re, win_im):
        s_w, _ = jax.lax.scan(step, start, (win_re[:w], win_im[:w]),
                              unroll=unroll)
        s_c, out_a = jax.lax.scan(step, s_w, (win_re[w:c], win_im[w:c]),
                                  unroll=unroll)
        s_f, out_b = jax.lax.scan(step, s_c, (win_re[c:], win_im[c:]),
                                  unroll=unroll)
        o_r = jnp.concatenate([out_a[0], out_b[0]])
        o_i = jnp.concatenate([out_a[1], out_b[1]])
        return s_w, s_c, s_f, o_r, o_i

    vrun = jax.vmap(chunk_run)

    # the loop's exact discrete symmetry: phase → phase + κ leaves the
    # error signal invariant (order 2: o→−o keeps o_r·o_i; order 4: ±i·o
    # keeps the signed error), so a chunk may lock κ·k away from the
    # sequential trajectory — detected at the seam and corrected exactly
    kappa = math.pi if order == 2 else math.pi / 2
    nbranch = 2 if order == 2 else 4

    def init_state():
        z = jnp.zeros((w,), jnp.float32)
        return (costas_init(), planar.PC(z, jnp.zeros_like(z)))

    def _wrap_pm_pi(x):
        return x - TWO_PI * jnp.round(x / TWO_PI)

    @jax.jit
    def run(state, frame):
        lag, tail = state
        n = frame.re.shape[-1]
        if n % c or n < c:
            raise ValueError(f"frame length {n} must be a multiple of {c}")
        nch = n // c
        ext_r = jnp.concatenate([tail.re, frame.re])
        ext_i = jnp.concatenate([tail.im, frame.im])
        win_r = jnp.stack([jax.lax.dynamic_slice_in_dim(ext_r, ci * c, w + c)
                           for ci in range(nch)])
        win_i = jnp.stack([jax.lax.dynamic_slice_in_dim(ext_i, ci * c, w + c)
                           for ci in range(nch)])
        first = jnp.arange(nch) == 0
        # phase prediction keeps the guess in the carried branch's basin
        pred = _wrap_pm_pi(lag.phase
                           + lag.freq * (jnp.arange(nch) * c).astype(jnp.float32))
        starts = (jnp.where(first, lag.phase, pred).astype(jnp.float32),
                  jnp.full((nch,), lag.freq, jnp.float32),
                  jnp.where(first, lag.error, 0.0).astype(jnp.float32))
        s_w, s_c, s_f, o_r, o_i = vrun(starts, win_r, win_i)

        # seam deltas: chunk c's warm-up-end state vs chunk c−1's final
        dphi = _wrap_pm_pi(s_w[0][1:] - s_f[0][:-1])
        dfreq = s_w[1][1:] - s_f[1][:-1]
        k = jnp.round(dphi / kappa).astype(jnp.int32)          # branch hops
        resid = jnp.maximum(jnp.max(jnp.abs(dphi - k * kappa),
                                    initial=0.0),
                            jnp.max(jnp.abs(dfreq), initial=0.0))
        bits = jnp.concatenate([jnp.zeros((1,), jnp.int32), k])
        b = jnp.cumsum(bits) % nbranch          # branch of each chunk
        # exact branch correction: out · e^{+i·b·κ} (sign flips / quadrant
        # swaps — no float rotation error)
        if order == 2:
            sgn = jnp.where(b % 2 == 0, 1.0, -1.0).astype(jnp.float32)
            o_r = o_r * sgn[:, None]
            o_i = o_i * sgn[:, None]
        else:
            b1, b2, b3 = b == 1, b == 2, b == 3
            nr = jnp.where(b1[:, None], -o_i,
                           jnp.where(b2[:, None], -o_r,
                                     jnp.where(b3[:, None], o_i, o_r)))
            ni = jnp.where(b1[:, None], o_r,
                           jnp.where(b2[:, None], -o_i,
                                     jnp.where(b3[:, None], -o_r, o_i)))
            o_r, o_i = nr, ni
        # certificate: bitwise seam equality (⇒ output == the sequential
        # scan's bit-for-bit, by induction from the exactly-carried chunk 0)
        exact = jnp.all((s_w[0][1:] == s_f[0][:-1])
                        & (s_w[1][1:] == s_f[1][:-1]))
        # carried state, mapped back to chunk 0's branch
        lag_phase = s_c[0][-1] - b[-1].astype(jnp.float32) * kappa
        lag_phase = jnp.where(
            (lag_phase > TWO_PI) | (lag_phase < -TWO_PI),
            (lag_phase / TWO_PI - jnp.trunc(lag_phase / TWO_PI)) * TWO_PI,
            lag_phase)
        o_r = o_r.reshape(n)
        o_i = o_i.reshape(n)
        lag_t = (lag_phase, s_c[1][-1], s_c[2][-1])
        fell_back = jnp.bool_(False)
        if exact_fallback_residual is not None:
            # bit-exactness on demand: when the certificate is suspect the
            # frame re-runs through the exact sequential recurrence (one
            # lax.cond — the latency cost is paid only on triggering
            # frames, e.g. during acquisition or after signal loss)
            def _seq(_):
                s_mid, (r1, i1) = jax.lax.scan(
                    step, tuple(lag), (ext_r[: n], ext_i[: n]),
                    unroll=unroll)
                _, (r2, i2) = jax.lax.scan(
                    step, s_mid, (ext_r[n:], ext_i[n:]), unroll=unroll)
                return (jnp.concatenate([r1[w:], r2]),
                        jnp.concatenate([i1[w:], i2]), s_mid)

            def _spec(_):
                return o_r, o_i, lag_t

            trip = resid > jnp.float32(exact_fallback_residual)
            o_r, o_i, lag_t = jax.lax.cond(trip, _seq, _spec, None)
            exact = exact | trip
            fell_back = trip
        new_lag = CostasState(phase=lag_t[0], freq=lag_t[1],
                              error=lag_t[2])
        new_tail = planar.PC(frame.re[n - w:], frame.im[n - w:])
        out = planar.PC(o_r, o_i)
        return ((new_lag, new_tail), out,
                {"exact": exact, "residual": resid,
                 "branch_hops": jnp.sum(jnp.abs(k)),
                 "fell_back": fell_back})

    run.init_state = init_state
    return run


def make_costas_loop(loop_bw: float, order: int,
                     max_freq: float = 1.0, min_freq: float = -1.0):
    """Build the jitted per-frame Costas loop: (state, frame) -> (state, out).

    order must be 2 or 4 (validated like lib/clCostasLoop_impl.cc:67-82).
    """
    if order not in (2, 4):
        raise ValueError("costas loop order must be 2 or 4")
    alpha, beta = costas_gains(loop_bw)
    alpha = jnp.float32(alpha)
    beta = jnp.float32(beta)
    f_max = jnp.float32(max_freq)
    f_min = jnp.float32(min_freq)

    def step(carry, sample):
        phase, freq, _ = carry
        nco = jnp.exp(-1j * phase.astype(jnp.complex64))
        out = (sample * nco).astype(jnp.complex64)
        o_r, o_i = out.real, out.imag
        if order == 2:
            error = o_r * o_i
        else:
            # 4th-order signed error (clCostasLoop_impl.cc:185-193)
            error = (jnp.where(o_r > 0, 1.0, -1.0) * o_i
                     - jnp.where(o_i > 0, 1.0, -1.0) * o_r)
        # branchless clip to ±1 (gr::branchless_clip)
        error = 0.5 * (jnp.abs(error + 1.0) - jnp.abs(error - 1.0))
        freq = freq + beta * error
        phase = phase + freq + alpha * error
        # phase wrap to ±2π via fmod, matching the kernel's wrap (:219-223)
        phase = jnp.where(
            (phase > TWO_PI) | (phase < -TWO_PI),
            (phase / TWO_PI - jnp.trunc(phase / TWO_PI)) * TWO_PI,
            phase,
        )
        freq = jnp.clip(freq, f_min, f_max)
        return (phase, freq, error), out

    @jax.jit
    def run(state: CostasState, frame):
        frame = jnp.asarray(frame, jnp.complex64)
        (phase, freq, error), out = jax.lax.scan(
            step, (state.phase, state.freq, state.error), frame, unroll=16
        )
        return CostasState(phase=phase, freq=freq, error=error), out

    return run
