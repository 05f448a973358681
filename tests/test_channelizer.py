"""Channelizer parity vs a numpy transcription of the reference's
filterpfb2 + batched reverse FFT + channel_map kernels
(lib/clPolyphaseChannelizer_impl.cc:156-225)."""

import numpy as np
import pytest

from clenabled_tpu.dsp import channelizer, firdes

RNG = np.random.default_rng(99)


def cplx(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(np.complex64)


def ref_channelize(x, taps, m, r, ch_map):
    """Direct numpy transcription of the reference kernels (oracle)."""
    t = len(taps)
    buf = len(x) - (t - 1)
    nout = buf // r
    filt = np.zeros((nout, m), np.complex128)
    for i in range(nout):
        for j in range(m):
            acc = 0.0 + 0.0j
            for k in range(j, t, m):
                acc += x[i * r - k + t - 1] * taps[k]
            filt[i, (j + i * (m - r)) % m] = acc
    z = np.fft.ifft(filt, axis=-1) * m
    return z[:, ch_map]


@pytest.mark.parametrize("m,r", [(8, 8), (8, 4), (16, 16), (6, 3)])
def test_channelizer_parity(m, r):
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)  # prototype
    buf = 24 * m
    x = cplx(buf + len(taps) - 1)
    ch_map = list(range(m))
    got = np.asarray(
        channelizer.polyphase_channelize(x, taps, m, r, ch_map)
    )
    want = ref_channelize(x.astype(np.complex128), taps.astype(np.float64), m, r, ch_map)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_channel_map_subset():
    m, r = 8, 8
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    buf = 16 * m
    x = cplx(buf + len(taps) - 1)
    ch_map = [2, 5, 7]
    got = np.asarray(channelizer.polyphase_channelize(x, taps, m, r, ch_map))
    want = ref_channelize(x.astype(np.complex128), taps.astype(np.float64), m, r, ch_map)
    assert got.shape == (buf // r, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tone_lands_in_expected_channel():
    m = 8
    fs = 8.0e6
    taps = firdes.low_pass(1.0, fs, fs / (2 * m) * 0.8, fs / (2 * m) * 0.4)
    buf = 64 * m
    q = 3  # tone at channel-3 center
    n = np.arange(buf + len(taps) - 1)
    x = np.exp(2j * np.pi * (q * fs / m) * n / fs).astype(np.complex64)
    out = np.asarray(
        channelizer.polyphase_channelize(x, taps, m, m, list(range(m)))
    )
    power = (np.abs(out[8:]) ** 2).mean(axis=0)  # skip filter ramp-in
    assert power.argmax() == q
    assert power[q] > 10 * np.sort(power)[-2]


def test_streaming_equals_oneshot():
    m, r = 8, 4
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    buf = 24 * m
    x = cplx(buf * 3)
    init, apply = channelizer.make_channelizer(taps, m, r, list(range(m)))
    state = init()
    outs = []
    for i in range(3):
        state, y = apply(state, x[i * buf : (i + 1) * buf])
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=0)
    hist = np.zeros(len(taps) - 1, np.complex64)
    want = ref_channelize(
        np.concatenate([hist, x]).astype(np.complex128),
        taps.astype(np.float64), m, r, list(range(m)),
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_validates_buf_multiple():
    taps = firdes.low_pass(1.0, 8.0, 0.5, 0.25)
    with pytest.raises(ValueError):
        channelizer.polyphase_channelize(cplx(len(taps) - 1 + 17), taps, 8, 8, [0])


def test_oversampled_phase_split_paths_agree():
    """The gather-free phase-split PFB (scalar and lane-packed planar
    variants) must agree bit-for-bit for every (M, R) shape class,
    including non-power-of-two M and i_offset (sharded rotation phase)."""
    import math

    import jax.numpy as jnp

    from clenabled_tpu.dsp import channelizer as C

    rng = np.random.default_rng(2)
    for (m, r) in [(16, 8), (16, 12), (8, 6), (3, 2), (12, 9)]:
        taps = rng.standard_normal(m * 4 + 3).astype(np.float32)
        taps_rm, t = C._pfb_constants(taps, m, r)
        ell = m // math.gcd(m, r)
        nout = ell * 30
        xr = rng.standard_normal(t - 1 + nout * r).astype(np.float32)
        xi = rng.standard_normal(t - 1 + nout * r).astype(np.float32)
        wr = np.asarray(C._pfb_oversampled(
            jnp.asarray(xr), taps_rm, m, r, t, nout, 5))
        wi = np.asarray(C._pfb_oversampled(
            jnp.asarray(xi), taps_rm, m, r, t, nout, 5))
        # scalar path vs the explicit commutator-gather formulation
        w = taps_rm.shape[0]
        import jax as _jax
        i_idx = _jax.lax.broadcasted_iota(jnp.int32, (nout, w * m), 0)
        n_idx = _jax.lax.broadcasted_iota(jnp.int32, (nout, w * m), 1)
        gidx = jnp.clip(i_idx * r + (t - 1) - n_idx, 0, xr.shape[-1] - 1)
        acc = C._branch_sums_gather(jnp.asarray(xr), taps_rm, gidx, nout, w, m)
        i_rot = _jax.lax.broadcasted_iota(jnp.int32, (nout, m), 0) + 5
        c_rot = _jax.lax.broadcasted_iota(jnp.int32, (nout, m), 1)
        src = jnp.mod(c_rot - i_rot * (m - r), m)
        want = np.asarray(jnp.take_along_axis(acc, src, axis=-1))
        np.testing.assert_allclose(wr, want, atol=1e-4 * max(1, np.abs(want).max()))
        # lane-packed planar variant vs scalar
        gr, gi = C._pfb_oversampled_planar(
            jnp.asarray(xr), jnp.asarray(xi), taps_rm, m, r, t, nout, 5)
        np.testing.assert_array_equal(np.asarray(gr), wr)
        np.testing.assert_array_equal(np.asarray(gi), wi)


def _stream_planar(taps, m, r, ch_map, x, nframes):
    """Run make_channelizer(planar=True) over ``nframes`` equal frames of
    the complex stream x (history carried between frames)."""
    from clenabled_tpu.dsp import planar

    n = len(x) // nframes
    init, apply = channelizer.make_channelizer(taps, m, r, ch_map,
                                               planar=True)
    st = init()
    got = []
    for i in range(nframes):
        fr = planar.PC(np.real(x[i * n:(i + 1) * n]),
                       np.imag(x[i * n:(i + 1) * n]))
        st, y = apply(st, fr)
        got.append(np.asarray(y.re) + 1j * np.asarray(y.im))
    return st, np.concatenate(got, axis=0)


def _oracle_stream(taps, m, r, ch_map, x):
    """ref_channelize over the whole stream with zero initial history."""
    xh = np.concatenate([np.zeros(len(taps) - 1), x]).astype(np.complex128)
    return ref_channelize(xh, np.asarray(taps, np.float64), m, r, ch_map)


def test_oversampled_streaming_matches_oracle():
    """Oversampled (R < M) planar streaming channelizer with a channel
    subset, carried across three frames, against the loop oracle on the
    whole stream — the rotation phase is global across frames."""
    m, r = 16, 8
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    ch_map = [0, 3, 7, 15]
    x = cplx(3 * 2048)
    _, got = _stream_planar(taps, m, r, ch_map, x, 3)
    want = _oracle_stream(taps, m, r, ch_map, x)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("m,r", [(16, 8), (16, 4), (16, 2)])
def test_oversampled_configs_match_oracle(m, r):
    """2×, 4× and 8× oversampling at 16 channels, one frame, all
    channels, against the loop oracle."""
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    x = cplx(1024)
    _, got = _stream_planar(taps, m, r, list(range(m)), x, 1)
    want = _oracle_stream(taps, m, r, list(range(m)), x)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("m,r", [(64, 16), (32, 4), (16, 1)])
def test_oversampled_wide_configs_streaming_match_oracle(m, r):
    """Wider channel counts and deep oversampling (M=64/R=16, M=32/R=4,
    M=16/R=1), two carried frames, against the loop oracle."""
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    x = cplx(2 * 2048)
    _, got = _stream_planar(taps, m, r, list(range(m)), x, 2)
    want = _oracle_stream(taps, m, r, list(range(m)), x)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_oversampled_deep_halo_long_prototype():
    """A long prototype (more than 1024 taps at M=64, R=16): the carried
    history is ntaps−1 samples and two carried frames match the loop
    oracle on the whole stream."""
    m, r = 64, 16
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.08)
    assert len(taps) > 1024
    x = cplx(2 * 4096)
    st, got = _stream_planar(taps, m, r, list(range(m)), x, 2)
    assert st[0].shape == (len(taps) - 1,)
    np.testing.assert_array_equal(np.asarray(st[0]),
                                  np.real(x[-(len(taps) - 1):]))
    want = _oracle_stream(taps, m, r, list(range(m)), x)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_oversampled_deep_prototype_streaming_equals_oneshot():
    """A deeper prototype (transition 0.04 at M=64, R=16): two carried
    planar frames equal one complex64 pass over the whole stream."""
    m, r = 64, 16
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.04)
    x = cplx(2 * 4096)
    _, got = _stream_planar(taps, m, r, list(range(m)), x, 2)
    xh = np.concatenate([np.zeros(len(taps) - 1, np.complex64), x])
    want = np.asarray(channelizer.polyphase_channelize(
        xh, taps, m, r, list(range(m))))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
