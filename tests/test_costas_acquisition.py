"""Chunked-Costas ACQUISITION behavior: the chunked loop's
certificate semantics were specified for locked streams only; these tests
measure cold-start and lock-loss behavior — how many frames until the
certificate passes, how large the pre-lock divergence is, and that the
``exact_fallback_residual`` policy restores bit-exactness vs the
sequential recurrence on exactly the frames that need it."""

import numpy as np
import pytest

from clenabled_tpu.dsp import demod, planar

CHUNK, WARMUP, FRAME = 1024, 512, 4096
LOOP_BW, ORDER = 0.01, 2


def _bpsk(n, w, seed, phase0=0.0, snr_amp=0.02):
    rng = np.random.default_rng(seed)
    sym = rng.choice([0.0, np.pi], size=(n + 31) // 32).repeat(32)[:n]
    ph = phase0 + w * np.arange(n) + sym
    x = np.cos(ph) + 1j * np.sin(ph)
    x += snr_amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return planar.PC(np.real(x).astype(np.float32),
                     np.imag(x).astype(np.float32))


def _sequential(frames):
    run = demod.make_costas_loop_planar(LOOP_BW, ORDER)
    st = demod.costas_init()
    outs = []
    for fr in frames:
        st, o = run(st, fr)
        outs.append(np.asarray(o.re) + 1j * np.asarray(o.im))
    return np.concatenate(outs)


def _frames(x, nf):
    return [planar.PC(x.re[i * FRAME:(i + 1) * FRAME],
                      x.im[i * FRAME:(i + 1) * FRAME]) for i in range(nf)]


def test_cold_start_certifies_within_frames_and_bounds_divergence():
    """From a zero state with a real frequency offset: the certificate
    must FLAG the acquisition transient (high residual), then certify
    once locked; the locked tail must agree with the sequential run."""
    nf = 6
    x = _bpsk(nf * FRAME, 0.005, seed=0)
    frames = _frames(x, nf)
    want = _sequential(frames)

    run = demod.make_costas_loop_chunked(LOOP_BW, ORDER, chunk=CHUNK,
                                         warmup=WARMUP)
    st = run.init_state()
    resids, exacts, got = [], [], []
    for fr in frames:
        st, o, d = run(st, fr)
        resids.append(float(d["residual"]))
        exacts.append(bool(d["exact"]))
        got.append(np.asarray(o.re) + 1j * np.asarray(o.im))
    got = np.concatenate(got)
    # the locked tail certifies (the loop time constant at bw=0.01 is
    # ~100 samples — well inside one 4096-sample frame; later frames must
    # be exact or within float-dither residual)
    assert resids[-1] < 1e-4, resids
    assert min(resids[:2]) < max(resids) or exacts[-1]
    # divergence is confined to the flagged region: wherever the
    # certificate was suspect the outputs may differ (speculative chunks
    # pre-lock), but certified frames match the sequential trajectory
    first_exactish = next(i for i, r in enumerate(resids) if r < 1e-4)
    assert first_exactish <= 2, resids   # certifies by the 3rd frame
    tail = slice((first_exactish + 1) * FRAME, None)
    np.testing.assert_allclose(got[tail], want[tail], atol=5e-3)


def test_lock_loss_flags_one_frame_and_recovers():
    """A mid-stream phase+frequency step: the frame containing the jump
    reports a residual spike (certificate correctly refuses), and the
    loop re-certifies after re-locking."""
    nf = 8
    a = _bpsk(4 * FRAME, 0.005, seed=1)
    b = _bpsk(4 * FRAME, -0.008, seed=2, phase0=2.0)
    x = planar.PC(np.concatenate([a.re, b.re]), np.concatenate([a.im, b.im]))
    frames = _frames(x, nf)
    run = demod.make_costas_loop_chunked(LOOP_BW, ORDER, chunk=CHUNK,
                                         warmup=WARMUP)
    st = run.init_state()
    resids = []
    for fr in frames:
        st, o, d = run(st, fr)
        resids.append(float(d["residual"]))
    locked_before = min(resids[1:4])
    spike = max(resids[4:6])             # the jump lands in frame 4
    assert spike > 10 * max(locked_before, 1e-7), resids
    assert resids[-1] < 1e-4, resids     # re-certified after re-lock


def test_exact_fallback_policy():
    """exact_fallback_residual: frames whose certificate is suspect
    (acquisition) re-run the exact sequential recurrence — their output
    is BIT-IDENTICAL to the sequential form — while certified locked
    frames stay on the fast speculative path (within float dither of the
    sequential trajectory, bounded by the threshold)."""
    nf = 5
    x = _bpsk(nf * FRAME, 0.005, seed=3)
    frames = _frames(x, nf)
    want = _sequential(frames)

    run = demod.make_costas_loop_chunked(LOOP_BW, ORDER, chunk=CHUNK,
                                         warmup=WARMUP,
                                         exact_fallback_residual=1e-4)
    st = run.init_state()
    got, fb = [], []
    for fr in frames:
        st, o, d = run(st, fr)
        fb.append(bool(d["fell_back"]))
        if d["fell_back"]:
            assert bool(d["exact"])      # fallback frames report exact
        got.append(np.asarray(o.re) + 1j * np.asarray(o.im))
    got = np.concatenate(got)
    assert fb[0], fb                     # acquisition frame fell back
    assert not any(fb[1:]), fb           # locked frames stay speculative
    # the fallen-back acquisition frame is bit-identical to sequential
    np.testing.assert_array_equal(got[:FRAME], want[:FRAME])
    # the whole stream stays within float-dither of the sequential run
    np.testing.assert_allclose(got, want, atol=5e-3)
