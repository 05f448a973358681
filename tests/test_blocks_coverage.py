"""Every named block runs in a flowgraph at least once (smoke + numerics)
— the per-block coverage the reference gets from its test_flowgraphs set."""

import numpy as np
import pytest

from clenabled_tpu import blocks
from clenabled_tpu.dsp import firdes
from clenabled_tpu.streaming import Flowgraph

RNG = np.random.default_rng(99)


def cplx(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
        np.complex64
    )


def run_one(block, *feeds, frame=1024, n_out=1):
    g = Flowgraph()
    for p in range(block.n_inputs):
        g.external_input(block, p)
    taps = [g.tap(block, p, name=f"o{p}") for p in range(block.n_outputs)]
    r = g.compile(frame_size=frame)
    out = r.step(*feeds)
    return [np.asarray(out[t]) for t in taps]


def test_mathop_aliases():
    a, b = cplx(1024), cplx(1024)
    assert np.allclose(run_one(blocks.Multiply(), a, b)[0], a * b)
    assert np.allclose(run_one(blocks.Add(), a, b)[0], a + b)
    assert np.allclose(run_one(blocks.Subtract(), a, b)[0], a - b)
    assert np.allclose(run_one(blocks.MultiplyConjugate(), a, b)[0],
                       a * np.conj(b))
    assert np.allclose(run_one(blocks.ComplexConjugate(), a)[0], np.conj(a))


def test_const_blocks():
    a = cplx(1024)
    assert np.allclose(run_one(blocks.MultiplyConst(2.5), a)[0], a * 2.5,
                       rtol=1e-6)
    got = run_one(blocks.AddConst(1.5), a)[0]
    assert np.allclose(got, a + 1.5, rtol=1e-6)


def test_log_and_snr():
    f = np.abs(RNG.standard_normal(1024)).astype(np.float32) + 0.1
    g2 = np.abs(RNG.standard_normal(1024)).astype(np.float32) + 0.1
    got = run_one(blocks.Log(nValue=10.0, kValue=2.0), f)[0]
    np.testing.assert_allclose(got, 10 * np.log10(f) + 2, rtol=1e-4, atol=1e-4)
    got = run_one(blocks.SNRHelper(nValue=10.0), f, g2)[0]
    np.testing.assert_allclose(got, np.abs(10 * np.log10(f / g2)),
                               rtol=1e-4, atol=1e-4)


def test_kernel_2to1():
    import jax.numpy as jnp

    k = blocks.Kernel2To1(fn=lambda x, y: (x * y + 1.0).astype(jnp.complex64))
    a, b = cplx(512), cplx(512)
    got = run_one(k, a, b, frame=512)[0]
    np.testing.assert_allclose(got, a * b + 1.0, rtol=1e-5, atol=1e-5)


def test_complex_filter_block():
    taps = firdes.complex_band_pass(1.0, 1e6, -100e3, 200e3, 80e3)
    blk = blocks.ComplexFilter(1, taps, use_time=True)
    x = cplx(2048)
    got = run_one(blk, x, frame=2048)[0]
    want = np.convolve(np.concatenate([np.zeros(len(taps) - 1, np.complex64), x]),
                       taps, mode="valid")
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("factory,kwargs", [
    (blocks.HighPassFilter, dict(decimation=1, gain=1.0, samp_rate=1e6,
                                 cutoff_freq=200e3, transition_width=80e3)),
    (blocks.BandPassFilter, dict(decimation=1, gain=1.0, samp_rate=1e6,
                                 low_cutoff=100e3, high_cutoff=300e3,
                                 transition_width=80e3)),
    (blocks.BandRejectFilter, dict(decimation=1, gain=1.0, samp_rate=1e6,
                                   low_cutoff=100e3, high_cutoff=300e3,
                                   transition_width=80e3)),
    (blocks.RootRaisedCosineFilter, dict(decimation=1, gain=1.0,
                                         samp_rate=1e6, symbol_rate=250e3,
                                         alpha=0.35, ntaps=65)),
])
def test_filter_wrapper_blocks(factory, kwargs):
    blk = factory(use_time=True, **kwargs)
    x = cplx(2048)
    got = run_one(blk, x, frame=2048)[0]
    taps = blk.taps()
    want = np.convolve(np.concatenate([np.zeros(len(taps) - 1, np.complex64), x]),
                       taps, mode="valid")
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_costas_block_in_graph():
    bits = RNG.integers(0, 2, 4096) * 2 - 1
    x = (bits * np.exp(1j * 0.4)).astype(np.complex64)
    blk = blocks.CostasLoop(0.05, 2)
    got = run_one(blk, x, frame=4096)[0]
    assert np.abs(got[-500:].imag).mean() < 0.05  # locked


def test_fft_reverse_in_graph():
    x = cplx(2048)
    blk = blocks.Fft(512, direction=-1, shift=True)
    got = run_one(blk, x, frame=2048)[0].reshape(4, 512)
    xb = x.reshape(4, 512)
    want = np.fft.ifft(np.concatenate([xb[:, 256:], xb[:, :256]], -1),
                       axis=-1) * 512
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_empty_mathop_passthrough():
    from clenabled_tpu.dsp import elementwise as ew

    a = cplx(256)
    got = run_one(blocks.MathOp(ew.MATHOP_EMPTY), a, frame=256)[0]
    np.testing.assert_array_equal(got, a)


def test_legacy_kwargs_accepted():
    """Reference make() callers pass the OpenCL device tuple + idataType —
    all accepted and ignored."""
    legacy = dict(idataType=1, openCLPlatformType=4, devSelector=1,
                  platformId=0, devId=0, setDebug=0)
    blocks.MathOp(1, **legacy)
    blocks.SignalSource(1e6, 1, 1e3, 1.0, 1024, **legacy)
    blocks.Fft(512, **legacy)
    blocks.QuadratureDemod(1.0, **legacy)
    with pytest.raises(TypeError):
        blocks.MathOp(1, not_a_param=3)


def test_complex_filter_set_taps_preserves_complex():
    taps1 = firdes.complex_band_pass(1.0, 1e6, -100e3, 200e3, 80e3)
    blk = blocks.ComplexFilter(1, taps1, use_time=True)
    taps2 = firdes.complex_band_pass(1.0, 1e6, -50e3, 150e3, 80e3)
    blk.set_taps2(taps2)
    assert np.iscomplexobj(blk.taps())
    np.testing.assert_allclose(blk.taps(), taps2.astype(np.complex64))


@pytest.mark.parametrize("planar", [False, True])
def test_clenabled_tool_runs_both_complex_forms(planar, monkeypatch, capsys):
    """The test_clenabled CLI takes the complex64 path by default and the
    planar path with --planar, and reports the copy baseline for both."""
    import sys as _sys

    from clenabled_tpu.runtime import config
    from clenabled_tpu.tools import test_clenabled as tool

    # keep this worker's compile-cache setting untouched
    monkeypatch.setattr(config, "init_compile_cache", lambda: "")
    argv = ["test_clenabled", "--cpu", "--iterations", "2",
            "--baseline-only", "4096"]
    if planar:
        argv.insert(1, "--planar")
    monkeypatch.setattr(_sys, "argv", argv)
    tool.main()
    out = capsys.readouterr().out
    assert "platform: cpu" in out
    assert "empty w/copy (baseline)" in out
