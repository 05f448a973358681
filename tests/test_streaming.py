"""Flowgraph/scheduler tests: the minimum end-to-end slice from SURVEY §7
(SignalSource → Fft → MultiplyConst → probe) plus rate changes, carried
state across frames, multi-port blocks and message dispatch."""

import numpy as np
import pytest

from clenabled_tpu import blocks
from clenabled_tpu.dsp import firdes
from clenabled_tpu.dsp import window as win
from clenabled_tpu.streaming import Flowgraph


def test_minimum_slice_source_fft_multiply():
    """BASELINE config[0]: 2048-pt forward FFT + multiply-const."""
    fs, f0, n = 1e6, 250e3, 8192
    g = Flowgraph()
    src = blocks.SignalSource(fs, blocks.core.siggen.SIGSOURCE_COS, f0, 1.0, n)
    fft = blocks.Fft(2048, window=win.blackman_harris(2048), shift=True)
    mc = blocks.MultiplyConst(2.0)
    g.connect(src, fft)
    g.connect(fft, mc)
    tap = g.tap(mc, name="out")
    r = g.compile()
    out = np.asarray(r.step()[tap]).reshape(4, 2048)
    # peak at shifted bin 1024 + f0/fs*2048 = 1024+512
    peak_bins = np.abs(out).argmax(axis=-1)
    np.testing.assert_array_equal(peak_bins, 1024 + 512)
    # multiply-const doubled the magnitude vs raw fft
    g2 = Flowgraph()
    src2 = blocks.SignalSource(fs, 1, f0, 1.0, n)
    fft2 = blocks.Fft(2048, window=win.blackman_harris(2048), shift=True)
    g2.connect(src2, fft2)
    t2 = g2.tap(fft2, name="o")
    raw = np.asarray(g2.compile().step()[t2])
    np.testing.assert_allclose(np.abs(out.reshape(-1)), 2 * np.abs(raw),
                               rtol=1e-4, atol=1e-2)


def test_external_input_and_decimating_filter_chain():
    """Host-fed stream → LPF(decim 2, freq-domain) → mag; streaming over 3
    frames == one-shot filtering (state carried through scheduler)."""
    rng = np.random.default_rng(0)
    lpf = blocks.LowPassFilter(2, 1.0, 1e6, 100e3, 50e3)
    mag = blocks.ComplexToMag()
    g = Flowgraph()
    feed = g.external_input(lpf)
    g.connect(lpf, mag)
    tap = g.tap(mag, name="m")
    frame = lpf.quantum * 2
    r = g.compile(frame_size=frame)
    x = (rng.standard_normal(3 * frame) + 1j * rng.standard_normal(3 * frame)
         ).astype(np.complex64)
    outs = [np.asarray(r.step(x[i * frame:(i + 1) * frame])[tap]) for i in range(3)]
    got = np.concatenate(outs)
    taps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    want = np.abs(np.convolve(x, taps)[: len(x)][::2])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert len(got) == 3 * frame // 2


def test_two_port_block_and_fan_out():
    """ComplexToMagPhase (2 outs) + MagPhaseToComplex (2 ins) roundtrip."""
    rng = np.random.default_rng(1)
    split = blocks.ComplexToMagPhase()
    join = blocks.MagPhaseToComplex()
    g = Flowgraph()
    feed = g.external_input(split)
    g.connect(split, join, src_port=0, dst_port=0)
    g.connect(split, join, src_port=1, dst_port=1)
    tap = g.tap(join, name="rt")
    r = g.compile(frame_size=1024)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(
        np.complex64
    )
    got = np.asarray(r.step(x)[tap])
    np.testing.assert_allclose(got, x, rtol=1e-4, atol=1e-5)


def test_fm_receiver_chain():
    """Source(FM-ish) → QuadratureDemod over multiple frames: continuous."""
    fs, n = 1e6, 4096
    src = blocks.SignalSource(fs, 1, 100e3, 1.0, n)
    qd = blocks.QuadratureDemod(1.0)
    g = Flowgraph()
    g.connect(src, qd)
    tap = g.tap(qd, name="demod")
    r = g.compile()
    o1 = np.asarray(r.step()[tap])
    o2 = np.asarray(r.step()[tap])
    expect = 2 * np.pi * 100e3 / fs
    np.testing.assert_allclose(o1[1:], expect, rtol=1e-2)
    # frame 2 has NO discontinuity at sample 0 (history carried)
    np.testing.assert_allclose(o2, expect, rtol=1e-2)


def test_xcorrelate_message_port():
    """XCorrelate sink publishes corr results via message callback."""
    rng = np.random.default_rng(2)
    n, shift, delay = 4096, 256, 33
    base = rng.standard_normal(3 * n).astype(np.float32)
    a = base[1000:1000 + n]
    b = base[1000 - delay:1000 - delay + n]
    xc = blocks.XCorrelate(2, signal_length=n, max_search_index=shift)
    g = Flowgraph()
    g.external_input(xc, 0)
    g.external_input(xc, 1)
    r = g.compile(frame_size=n)
    got = []
    r.on_message("xcorr.corr", lambda m: got.append(m))
    r.step(a, b)
    assert len(got) == 1
    assert bool(got[0]["valid"])
    assert int(np.asarray(got[0]["corrective_lags"])[0]) == -delay


def test_xcorrelate_frame_decimation():
    n, shift = 1024, 64
    xc = blocks.XCorrelate(2, signal_length=n, max_search_index=shift,
                           decim_frames=3)
    g = Flowgraph()
    g.external_input(xc, 0)
    g.external_input(xc, 1)
    r = g.compile(frame_size=n)
    valids = []
    r.on_message("xcorr.corr", lambda m: valids.append(bool(m["valid"])))
    rng = np.random.default_rng(3)
    for _ in range(6):
        a = rng.standard_normal(n).astype(np.float32)
        r.step(a, a)
    assert valids == [True, False, False, True, False, False]


def test_channelizer_in_graph_rate():
    m = 8
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    ch = blocks.PolyphaseChannelizer(taps, 512, m, m, list(range(m)))
    g = Flowgraph()
    g.external_input(ch)
    tap = g.tap(ch, name="chans")
    r = g.compile(frame_size=512)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(
        np.complex64
    )
    out = np.asarray(r.step(x)[tap])
    assert out.shape == (512,)  # M channels × 512/M groups, interleaved


def test_frame_quantum_validated():
    lpf = blocks.LowPassFilter(2, 1.0, 1e6, 100e3, 50e3)
    g = Flowgraph()
    g.external_input(lpf)
    g.tap(lpf)
    with pytest.raises(ValueError):
        g.compile(frame_size=lpf.quantum + 1)


def test_cycle_detection():
    a = blocks.MultiplyConst(1.0)
    b = blocks.MultiplyConst(2.0)
    g = Flowgraph()
    g.connect(a, b)
    with pytest.raises(ValueError):
        g.connect(b, a)
        g.compile()


def test_checkpoint_resume(tmp_path):
    """Runner state (filter tail + demod history) checkpoints and resumes
    the stream sample-exactly."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(3 * 1024) + 1j * rng.standard_normal(3 * 1024)
         ).astype(np.complex64)

    def build():
        lpf = blocks.LowPassFilter(1, 1.0, 1e6, 100e3, 50e3, use_time=True)
        qd = blocks.QuadratureDemod(1.0)
        g = Flowgraph()
        g.external_input(lpf)
        g.connect(lpf, qd)
        t = g.tap(qd, name="y")
        return g.compile(frame_size=1024), t

    r1, t1 = build()
    o0 = np.asarray(r1.step(x[:1024])[t1])
    ckpt = str(tmp_path / "state.pkl")
    r1.save_state(ckpt)
    o1 = np.asarray(r1.step(x[1024:2048])[t1])

    r2, t2 = build()
    r2.load_state(ckpt)
    o1b = np.asarray(r2.step(x[1024:2048])[t2])
    np.testing.assert_array_equal(o1, o1b)
    assert r1.stats["steps"] == 2 and r1.throughput_msps() > 0


def test_checkpoint_mismatch_rejected(tmp_path):
    lpf = blocks.LowPassFilter(1, 1.0, 1e6, 100e3, 50e3, use_time=True)
    g = Flowgraph()
    g.external_input(lpf)
    g.tap(lpf)
    r = g.compile(frame_size=1024)
    ckpt = str(tmp_path / "s.pkl")
    r.save_state(ckpt)
    other = Flowgraph()
    src = blocks.SignalSource(1e6, 1, 1e3, 1.0, 1024)
    other.connect(src, blocks.ComplexToMag())
    r2 = other.compile()
    with pytest.raises(ValueError):
        r2.load_state(ckpt)


def test_long_run_stability():
    """Soak: 200 frames through a stateful chain — outputs stay finite,
    state doesn't blow up, stream continuity holds throughout."""
    rng = np.random.default_rng(12)
    lpf = blocks.LowPassFilter(1, 1.0, 1e6, 100e3, 50e3)
    qd = blocks.QuadratureDemod(1.0)
    g = Flowgraph()
    g.external_input(lpf)
    g.connect(lpf, qd)
    tap = g.tap(qd, name="y")
    frame = lpf.quantum
    r = g.compile(frame_size=frame)
    x = np.exp(1j * 0.3 * np.arange(200 * frame)).astype(np.complex64)
    last = None
    for i in range(200):
        out = np.asarray(r.step(x[i * frame:(i + 1) * frame])[tap])
        assert np.isfinite(out).all(), f"non-finite output at frame {i}"
        if i > 2:  # past filter ramp-in: constant-frequency tone → 0.3 rad
            np.testing.assert_allclose(out, 0.3, atol=1e-2)
        last = out
    assert last is not None and r.stats["steps"] == 200


def test_multirate_interp_and_decimator_graph():
    """A 1:4 interpolator feeding a 1/2 decimating filter runs
    through the scheduler (mismatched quanta resolved by super-framing),
    matches the dsp-layer composition, and checkpoints/resumes."""
    import os
    import tempfile

    from clenabled_tpu.dsp import fir_filter as dsp_fir

    interp, decim = 4, 2
    itaps = firdes.low_pass(float(interp), 4.0, 0.4, 0.2)
    dtaps = firdes.low_pass(1.0, 1.0, 0.2, 0.1)
    up = blocks.InterpFirFilter(interp, itaps)
    lpf = blocks.Filter(decim, dtaps, use_time=True)
    g = Flowgraph()
    g.external_input(up)
    g.connect(up, lpf)
    tap = g.tap(lpf, name="out")
    r = g.compile(frame_size=512)
    assert r.frames[(id(up), 0)] == 512 * interp
    assert r.frames[(id(lpf), 0)] == 512 * interp // decim

    rng = np.random.default_rng(8)
    x = (rng.standard_normal(3 * 512)
         + 1j * rng.standard_normal(3 * 512)).astype(np.complex64)
    outs = [np.asarray(r.step(x[k * 512:(k + 1) * 512])["out"])
            for k in range(2)]

    # checkpoint after 2 frames, resume in a fresh runner
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.pkl")
        r.save_state(path)
        r2 = g.compile(frame_size=512)
        r2.load_state(path)
        out3a = np.asarray(r.step(x[1024:1536])["out"])
        out3b = np.asarray(r2.step(x[1024:1536])["out"])
    np.testing.assert_array_equal(out3a, out3b)

    # parity vs the dsp-layer composition over the whole stream
    iinit, iapply = dsp_fir.make_interp_fir_filter(itaps, interp)
    st, y = iapply(iinit(), x)
    finit, fapply = dsp_fir.make_fir_filter(dtaps, decim, complex_input=True)
    nf = 512 * interp
    fstate = finit()
    want = []
    for k in range(3):
        fstate, w = fapply(fstate, np.asarray(y)[k * nf:(k + 1) * nf])
        want.append(np.asarray(w))
    got = np.concatenate(outs + [out3a])
    np.testing.assert_allclose(got, np.concatenate(want), rtol=1e-4,
                               atol=1e-4)


def test_multirate_auto_frame_size():
    """compile(frame_size=None) picks the minimal super-frame satisfying
    every quantum/rate constraint; an invalid explicit size errors."""
    interp = 3
    itaps = firdes.low_pass(float(interp), 3.0, 0.4, 0.2)
    up = blocks.InterpFirFilter(interp, itaps)
    # decimating filter with quantum = decimation = 8 fed at rate 3
    dtaps = firdes.low_pass(1.0, 1.0, 0.2, 0.1)
    lpf = blocks.Filter(8, dtaps, use_time=True)
    g = Flowgraph()
    g.external_input(up)
    g.connect(up, lpf)
    g.tap(lpf)
    r = g.compile(frame_size=None)
    assert r.frame_size == 8  # B·3 ≡ 0 mod 8 → minimal B = 8
    with pytest.raises(ValueError):
        g.compile(frame_size=12)


def test_compile_precision_flag():
    """Flowgraph.compile(precision="float32") traces the step under exact
    matmul precision (numerically a no-op on CPU, where float32 dots are
    exact already) and survives a
    refresh()."""
    import numpy as np
    from clenabled_tpu import blocks
    from clenabled_tpu.streaming import Flowgraph

    g = Flowgraph()
    src = blocks.SignalSource(1e6, 1, 150e3, 1.0, 4096)
    fft = blocks.Fft(1024, shift=True)
    mag = blocks.ComplexToMag()
    g.connect(src, fft)
    g.connect(fft, mag)
    tap = g.tap(mag)
    r_exact = g.compile(precision="float32")
    r_def = g.compile()
    a = np.asarray(r_exact.step()[tap])
    b = np.asarray(r_def.step()[tap])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    r_exact.refresh()
    a2 = np.asarray(r_exact.step()[tap])
    assert a2.shape == a.shape


def test_per_block_debug_surface(capsys):
    """Round-3 operability parity with the reference's setDebug +
    CLPRINT_NITEMS (lib/GRCLBase.cpp:15): a debug block dumps its lowered
    HLO once and logs per-dispatch item counts; Runner.lowered_text
    returns the block's StableHLO at its in-graph shapes."""
    g = Flowgraph()
    src = blocks.SignalSource(1e6, 1, 125e3, 1.0, 4096)
    mag = blocks.ComplexToMag(setDebug=True)  # legacy kwarg spelled enabled
    g.connect(src, mag)
    g.tap(mag, name="m")
    r = g.compile()
    r.step()
    out = capsys.readouterr().out
    assert "lowered HLO" in out
    assert "4096 items/step" in out
    txt = r.lowered_text(mag)
    assert "module" in txt
    r.step()
    out2 = capsys.readouterr().out
    assert "lowered HLO" not in out2       # dumped only once
    assert "items/step" in out2
    # modern chainable spelling
    assert blocks.ComplexToArg().set_debug().debug is True
