"""Tests for signal source (carried phase) and demodulators (quadrature
demod history, Costas loop recurrence vs a numpy reference loop)."""

import math

import numpy as np
import pytest

from clenabled_tpu.dsp import demod, siggen


def test_siggen_complex_continuous_across_frames():
    fs, f0, n = 1e6, 123e3, 4096
    init, gen = siggen.make_signal_source(fs, siggen.SIGSOURCE_COS, f0, 1.0, n)
    state = init()
    frames = []
    for _ in range(4):
        state, frame = gen(state)
        frames.append(np.asarray(frame))
    got = np.concatenate(frames)
    t = np.arange(4 * n, dtype=np.float64)
    ang = 2 * np.pi * f0 / fs * t
    want = np.cos(ang) + 1j * np.sin(ang)
    # float32 trig on wrapped angles: expect ~1e-4 absolute agreement
    np.testing.assert_allclose(got, want.astype(np.complex64), atol=5e-4)


def test_siggen_float_waveforms():
    fs, f0, n = 48e3, 1e3, 480
    for wf, ref in [(siggen.SIGSOURCE_COS, np.cos), (siggen.SIGSOURCE_SIN, np.sin)]:
        init, gen = siggen.make_signal_source(fs, wf, f0, 2.0, n, dtype=np.float32)
        _, frame = gen(init())
        ang = 2 * np.pi * f0 / fs * np.arange(n)
        np.testing.assert_allclose(np.asarray(frame), 2.0 * ref(ang), atol=5e-4)


def test_quadrature_demod_matches_reference_formula():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(
        np.complex64
    )
    gain = 0.7
    y, last = demod.quadrature_demod(x, gain)
    # reference: out[i] = gain*atan2(imag, real) of x[i+1]*conj(x[i]), with
    # 1-sample history; our frame-aligned form outputs y[i] from (x[i-1],x[i])
    prod = x[1:] * np.conj(x[:-1])
    want = gain * np.arctan2(prod.imag, prod.real)
    np.testing.assert_allclose(np.asarray(y)[1:], want, rtol=1e-4, atol=1e-5)
    assert abs(np.asarray(y)[0]) < 1e-6  # first sample vs itself (fma noise)
    assert np.asarray(last)[0] == x[-1]


def test_quadrature_demod_fm_tone():
    # constant-frequency tone → constant output = gain * 2π f/fs
    fs, f0, n = 1e6, 50e3, 2048
    t = np.arange(n) / fs
    x = np.exp(2j * np.pi * f0 * t).astype(np.complex64)
    y, _ = demod.quadrature_demod(x, 1.0)
    np.testing.assert_allclose(
        np.asarray(y)[1:], 2 * np.pi * f0 / fs, rtol=1e-3
    )


def _costas_numpy(x, loop_bw, order, n_out=None):
    """Reference recurrence transcribed from lib/clCostasLoop_impl.cc:151-312."""
    alpha, beta = demod.costas_gains(loop_bw)
    phase = freq = 0.0
    out = np.zeros_like(x)
    for i in range(len(x)):
        n_r, n_i = math.cos(-phase), math.sin(-phase)
        o_r = x[i].real * n_r - x[i].imag * n_i
        o_i = x[i].real * n_i + x[i].imag * n_r
        out[i] = o_r + 1j * o_i
        if order == 2:
            error = o_r * o_i
        else:
            error = (1.0 if o_r > 0 else -1.0) * o_i - (
                1.0 if o_i > 0 else -1.0
            ) * o_r
        error = 0.5 * (abs(error + 1) - abs(error - 1))
        freq += beta * error
        phase += freq + alpha * error
        if phase > 2 * math.pi or phase < -2 * math.pi:
            phase = (phase / (2 * math.pi) - int(phase / (2 * math.pi))) * 2 * math.pi
        freq = min(max(freq, -1.0), 1.0)
    return out


def test_costas_matches_reference_recurrence():
    rng = np.random.default_rng(11)
    # BPSK with small phase offset
    bits = rng.integers(0, 2, 512) * 2 - 1
    x = (bits * np.exp(1j * 0.3)).astype(np.complex64)
    for order in (2, 4):
        run = demod.make_costas_loop(0.02, order)
        state, out = run(demod.costas_init(), x)
        want = _costas_numpy(x.astype(np.complex128), 0.02, order)
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-3, atol=2e-3)


def test_costas_locks_bpsk_phase_offset():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 8000) * 2 - 1
    x = (bits * np.exp(1j * 0.5)).astype(np.complex64)
    run = demod.make_costas_loop(0.05, 2)
    state, out = run(demod.costas_init(), x)
    tail = np.asarray(out)[-1000:]
    # locked: imaginary part driven to ~0
    assert np.abs(tail.imag).mean() < 0.02
    # carried state: a second frame starts already locked (no re-acquisition)
    _, out2 = run(state, x)
    head = np.asarray(out2)[:200]
    assert np.abs(head.imag).mean() < 0.02


def test_costas_order_validated():
    import pytest

    with pytest.raises(ValueError):
        demod.make_costas_loop(0.02, 3)


def test_costas_chunked_matches_sequential():
    """Speculative chunk-parallel Costas tracks the sequential scan across
    frames: bitwise when the certificate passes, within float dither of
    the branch-corrected trajectory otherwise."""
    import jax.numpy as jnp

    from clenabled_tpu.dsp import planar

    rng = np.random.default_rng(0)
    n = 4096
    nfr = 3
    # BPSK at a small carrier offset: the loop locks quickly at bw=0.1
    bits = rng.integers(0, 2, nfr * n) * 2 - 1
    t = np.arange(nfr * n)
    x = (bits * np.exp(1j * (2 * np.pi * 0.002 * t + 0.7))).astype(np.complex64)

    run_seq = demod.make_costas_loop_planar(0.1, 2)
    run_chk = demod.make_costas_loop_chunked(0.1, 2, chunk=1024, warmup=512)
    seq_state = demod.costas_init()
    chk_state = run_chk.init_state()
    for k in range(nfr):
        fr = planar.PC(jnp.asarray(x.real[k * n:(k + 1) * n]),
                       jnp.asarray(x.imag[k * n:(k + 1) * n]))
        seq_state, want = run_seq(seq_state, fr)
        chk_state, got, diag = run_chk(chk_state, fr)
        assert float(diag["residual"]) < 1e-3
        if bool(diag["exact"]):
            np.testing.assert_array_equal(np.asarray(got.re),
                                          np.asarray(want.re))
            np.testing.assert_array_equal(np.asarray(got.im),
                                          np.asarray(want.im))
        else:
            # branch-corrected trajectory: same signal, float dither only
            # (skip the first loop time constant after each seam)
            np.testing.assert_allclose(np.asarray(got.re),
                                       np.asarray(want.re), atol=2e-2)
            np.testing.assert_allclose(np.asarray(got.im),
                                       np.asarray(want.im), atol=2e-2)


def test_costas_chunked_ulp_residual_when_locked():
    """After acquisition the seam residual sits at the float32 ulp floor
    (trajectories contract to within rounding dither but modulated inputs
    prevent a bitwise merge) and no branch hops occur."""
    import jax.numpy as jnp

    from clenabled_tpu.dsp import planar

    rng = np.random.default_rng(3)
    n = 1 << 15
    bits = rng.integers(0, 2, 2 * n) * 2 - 1
    t = np.arange(2 * n)
    x = (bits * np.exp(1j * (2 * np.pi * 0.002 * t + 0.7))).astype(np.complex64)
    run_chk = demod.make_costas_loop_chunked(0.1, 2, chunk=4096, warmup=2048)
    st = run_chk.init_state()
    for k in range(2):
        fr = planar.PC(jnp.asarray(x.real[k * n:(k + 1) * n]),
                       jnp.asarray(x.imag[k * n:(k + 1) * n]))
        st, _, diag = run_chk(st, fr)
        assert float(diag["residual"]) < 1e-5
    assert int(diag["branch_hops"]) == 0


def test_costas_chunked_validates_frame():
    import pytest

    from clenabled_tpu.dsp import planar

    run = demod.make_costas_loop_chunked(0.1, 2, chunk=1024, warmup=256)
    st = run.init_state()
    with pytest.raises(ValueError):
        run(st, planar.PC(np.zeros(1000, np.float32),
                          np.zeros(1000, np.float32)))


@pytest.mark.parametrize("n", [1023, 1024, 4096, 4097])
def test_qdemod_planar_streaming_matches_numpy(n):
    """Planar quadrature demod over two carried frames whose lengths sit
    on both sides of 1024-sample boundaries, against the float64 NumPy
    formula on the whole stream (the carried sample makes the seam
    continuous)."""
    import jax.numpy as jnp

    from clenabled_tpu.dsp import planar

    rng = np.random.default_rng(7)
    x = (rng.standard_normal(2 * n)
         + 1j * rng.standard_normal(2 * n)).astype(np.complex64)
    last0 = np.complex64(0.3 - 0.7j)
    last = planar.PC(jnp.asarray([last0.real]), jnp.asarray([last0.imag]))
    got = []
    for k in range(2):
        fr = x[k * n:(k + 1) * n]
        y, last = demod.quadrature_demod_planar(
            planar.PC(jnp.asarray(fr.real), jnp.asarray(fr.imag)), 2.5, last)
        got.append(np.asarray(y))
    xs = np.concatenate([[last0], x]).astype(np.complex128)
    prod = xs[1:] * np.conj(xs[:-1])
    want = 2.5 * np.arctan2(prod.imag, prod.real)
    np.testing.assert_allclose(np.concatenate(got), want, rtol=1e-5,
                               atol=2e-5)
    assert complex(np.asarray(last.re)[0], np.asarray(last.im)[0]) == x[-1]


def test_qdemod_planar_outconcat_matches_reference_form():
    """The sliced-views form must equal the input-concat formulation
    exactly (it is the same arithmetic on the same values, just without
    materialized shifted copies)."""
    import jax.numpy as jnp

    from clenabled_tpu.dsp import demod, planar

    rng = np.random.default_rng(8)
    n = 777                        # odd length
    x = planar.PC(jnp.asarray(rng.standard_normal(n), jnp.float32),
                  jnp.asarray(rng.standard_normal(n), jnp.float32))
    last = planar.PC(jnp.asarray([0.1], jnp.float32),
                     jnp.asarray([0.2], jnp.float32))
    got, _ = demod.quadrature_demod_planar(x, 1.5, last)
    pr = jnp.concatenate([last.re, x.re[:-1]])
    pi = jnp.concatenate([last.im, x.im[:-1]])
    prod = planar.mul_conj(x, planar.PC(pr, pi))
    want = jnp.float32(1.5) * jnp.arctan2(prod.im, prod.re)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_costas_planar_matches_reference_recurrence_across_frames():
    """The planar lax.scan Costas loop, carried over two frames, against
    the NumPy transcription of the reference recurrence on the whole
    stream, for both loop orders; the block wires the same loop."""
    import jax.numpy as jnp

    from clenabled_tpu import blocks
    from clenabled_tpu.dsp import planar

    rng = np.random.default_rng(9)
    n = 1024
    bits = rng.integers(0, 2, n) * 2 - 1
    x = (bits * np.exp(1j * 0.3)).astype(np.complex64)
    for order in (2, 4):
        run = demod.make_costas_loop_planar(0.02, order)
        st = demod.costas_init()
        got = []
        for lo, hi in ((0, n // 2), (n // 2, n)):
            st, out = run(st, planar.PC(jnp.asarray(x.real[lo:hi]),
                                        jnp.asarray(x.imag[lo:hi])))
            got.append(np.asarray(out.re) + 1j * np.asarray(out.im))
        want = _costas_numpy(x.astype(np.complex128), 0.02, order)
        np.testing.assert_allclose(np.concatenate(got), want, rtol=1e-3,
                                   atol=2e-3)
    blk = blocks.CostasLoop(0.02, 2, planar=True)
    _, (out,), _ = blk.apply(blk.init_state(),
                             [planar.PC(jnp.asarray(x.real),
                                        jnp.asarray(x.imag))])
    np.testing.assert_allclose(
        np.asarray(out.re) + 1j * np.asarray(out.im),
        _costas_numpy(x.astype(np.complex128), 0.02, 2), rtol=1e-3,
        atol=2e-3)


def test_costas_block_execution_shape_conflicts_rejected():
    """chunked is exclusive with num_streams and needs planar frames —
    a silent fallback to a different engine is an error."""
    from clenabled_tpu import blocks

    with pytest.raises(ValueError, match="exclusive"):
        blocks.CostasLoop(0.02, 2, planar=True, chunked=True, num_streams=4)
    with pytest.raises(ValueError, match="planar"):
        blocks.CostasLoop(0.02, 2, chunked=True)
