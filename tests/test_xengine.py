"""X-Engine parity vs a numpy transcription of the reference cxmac kernel
(lib/clXEngine_impl.cc:727-790) plus unpack kernels (:831-858)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clenabled_tpu.dsp import xengine

RNG = np.random.default_rng(23)


def ref_xengine(z, npol):
    """Direct transcription: one (channel, baseline) at a time, cxmac
    accum += z0 * conj(z1), pol products XX, XY, YX, YY."""
    t, s, f, p = z.shape
    nb = s * (s + 1) // 2
    out = np.zeros((f, nb, p * p), np.complex128)
    for k in range(nb):
        s1 = int(-0.5 + np.sqrt(0.25 + 2 * k))
        s2 = k - (s1 + 1) * s1 // 2
        for ch in range(f):
            idx = 0
            for p0 in range(p):
                for p1 in range(p):
                    acc = 0.0 + 0.0j
                    for tt in range(t):
                        acc += z[tt, s1, ch, p0] * np.conj(z[tt, s2, ch, p1])
                    out[ch, k, idx] = acc
                    idx += 1
    return out


def cplx(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("s,npol", [(4, 2), (5, 1), (3, 2)])
def test_xengine_triangular_parity(s, npol):
    t, f = 16, 8
    z = cplx(t, s, f, npol)
    got = np.asarray(xengine.xengine_correlate(z, npol=npol))
    want = ref_xengine(z.astype(np.complex128), npol)
    assert got.shape == (f, xengine.num_baselines(s), npol * npol)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_xengine_full_matrix_hermitian():
    z = cplx(8, 4, 4, 2)
    g = np.asarray(
        xengine.xengine_correlate(z, npol=2, output_format=xengine.CLXCORR_FULL_MATRIX)
    )
    assert g.shape == (4, 8, 8)
    np.testing.assert_allclose(g, np.conj(np.swapaxes(g, 1, 2)), rtol=1e-4, atol=1e-4)
    # diagonal = per-(station,pol) power, real and positive
    d = np.diagonal(g, axis1=1, axis2=2)
    assert np.all(d.real > 0) and np.allclose(d.imag, 0, atol=1e-4)


def test_baseline_stations_order():
    st = xengine.baseline_stations(4)
    # xGPU triangular order: (0,0),(1,0),(1,1),(2,0),(2,1),(2,2),...
    np.testing.assert_array_equal(
        st,
        [[0, 0], [1, 0], [1, 1], [2, 0], [2, 1], [2, 2], [3, 0], [3, 1], [3, 2], [3, 3]],
    )


def test_unpack_char():
    raw = np.array([127, -127, 0, 64], np.int8)
    got = np.asarray(xengine.unpack_char(raw))
    np.testing.assert_allclose(
        got, [1.0 - 1.0j, 0.0 + (64 / 127) * 1j], rtol=1e-6
    )


def test_unpack_packed_4bit():
    # nibbles: I=3, Q=0xF(-1); I=8(->0), Q=7
    raw = np.array([0x3F, 0x87], np.uint8)
    got = np.asarray(xengine.unpack_packed_4bit(raw))
    np.testing.assert_allclose(got, [(3 - 1j) / 7.0, (0 + 7j) / 7.0], rtol=1e-6)


def test_streaming_pipeline_integration():
    s, f, npol, t = 3, 4, 2, 8
    init, apply = xengine.make_xengine(
        num_inputs=s, num_channels=f, npol=npol, integration_time=t,
        pipeline_integration=3,
    )
    state = init()
    frames = [cplx(t, s, f, npol) for _ in range(3)]
    outs = []
    for fr in frames:
        state, (out, ready) = apply(state, fr)
        outs.append((np.asarray(out), bool(ready)))
    assert outs[0][1] is False and outs[1][1] is False and outs[2][1] is True
    assert np.allclose(outs[0][0], 0) and np.allclose(outs[1][0], 0)
    want = sum(ref_xengine(fr.astype(np.complex128), npol) for fr in frames)
    np.testing.assert_allclose(outs[2][0], want, rtol=1e-4, atol=1e-4)
    # accumulator reset after emission
    assert np.allclose(np.asarray(state.accum), 0)


def test_apply_validates_shape():
    init, apply = xengine.make_xengine(2, 4, 2, 8)
    with pytest.raises(ValueError):
        apply(init(), cplx(4, 2, 4, 2))


def test_channel_major_matches_time_major():
    """xengine_correlate_channel_major (the channel-major marshal + optional
    bf16 Gram) must equal the time-major planar path exactly on ≤8-bit
    quantized data (bf16×bf16 products are exact; f32 accumulate)."""
    import jax.numpy as jnp

    from clenabled_tpu.dsp import planar

    t, s, f, p = 64, 6, 8, 2
    rng = np.random.default_rng(17)
    zr = rng.integers(-127, 128, (t, s, f, p)).astype(np.float32)
    zi = rng.integers(-127, 128, (t, s, f, p)).astype(np.float32)
    want = xengine.xengine_correlate_planar(
        planar.PC(jnp.asarray(zr), jnp.asarray(zi)), npol=p)

    # channel-major marshal: [F, T, S·P]
    cm_r = jnp.asarray(np.transpose(zr, (2, 0, 1, 3)).reshape(f, t, s * p))
    cm_i = jnp.asarray(np.transpose(zi, (2, 0, 1, 3)).reshape(f, t, s * p))
    for dt in (None, jnp.bfloat16):
        got = xengine.xengine_correlate_channel_major(
            cm_r, cm_i, npol=p, compute_dtype=dt)
        np.testing.assert_array_equal(np.asarray(got.re), np.asarray(want.re))
        np.testing.assert_array_equal(np.asarray(got.im), np.asarray(want.im))


def test_stacked_gram_matches_channel_major():
    """xengine_correlate_stacked (one Gram matmul) == the 4-einsum
    channel-major path, triangular and full-matrix."""
    rng = np.random.default_rng(0)
    f, t, s, p = 8, 64, 6, 2
    zr = rng.standard_normal((f, t, s * p)).astype(np.float32)
    zi = rng.standard_normal((f, t, s * p)).astype(np.float32)
    for fmt in (xengine.CLXCORR_TRIANGULAR_ORDER, xengine.CLXCORR_FULL_MATRIX):
        want = xengine.xengine_correlate_channel_major(
            jnp.asarray(zr), jnp.asarray(zi), npol=p, output_format=fmt)
        got = xengine.xengine_correlate_stacked(
            jnp.asarray(zr), jnp.asarray(zi), npol=p, output_format=fmt)
        np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                                   rtol=1e-5, atol=1e-4)


def test_stacked_gram_int8_exact():
    """int8 (IChar) operands: exact integer Gram, scaled once at the end."""
    rng = np.random.default_rng(1)
    f, t, s, p = 4, 128, 4, 2
    zr8 = rng.integers(-127, 128, (f, t, s * p), dtype=np.int8)
    zi8 = rng.integers(-127, 128, (f, t, s * p), dtype=np.int8)
    scale = 1.0 / (127.0 * 127.0)
    got = xengine.xengine_correlate_stacked(
        jnp.asarray(zr8), jnp.asarray(zi8), npol=p, scale=scale)
    want = xengine.xengine_correlate_channel_major(
        jnp.asarray(zr8.astype(np.float32) / 127.0),
        jnp.asarray(zi8.astype(np.float32) / 127.0), npol=p)
    # integer accumulation is exact; the f32 reference rounds per-step —
    # agreement to f32 precision of the final values
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                               rtol=1e-5, atol=1e-4)


def test_channel_major_pipeline_integration():
    """make_xengine_channel_major accumulates on device and emits every
    pipeline_integration calls (the reference's += kernels + zeroing)."""
    rng = np.random.default_rng(2)
    f, t, s, p = 4, 32, 3, 2
    init, apply = xengine.make_xengine_channel_major(
        s, f, p, t, pipeline_integration=3)
    state = init()
    frames = [(rng.standard_normal((f, t, s * p)).astype(np.float32),
               rng.standard_normal((f, t, s * p)).astype(np.float32))
              for _ in range(6)]
    total = None
    emitted = []
    for k, (zr, zi) in enumerate(frames):
        state, (out, ready) = apply(state, (jnp.asarray(zr), jnp.asarray(zi)))
        corr = xengine.xengine_correlate_stacked(
            jnp.asarray(zr), jnp.asarray(zi), npol=p)
        total = corr if total is None else (
            type(corr)(total.re + corr.re, total.im + corr.im))
        if bool(ready):
            emitted.append((k, np.asarray(out.re).copy(),
                            np.asarray(out.im).copy(),
                            np.asarray(total.re).copy()))
            total = None
        else:
            assert not np.any(np.asarray(out.re))
    assert [k for k, *_ in emitted] == [2, 5]
    for _, got_re, got_im, want_re in emitted:
        np.testing.assert_allclose(got_re, want_re, rtol=1e-5, atol=1e-4)


def test_unpack_4bit_arithmetic_matches_lut():
    """_nib_signed (gather-free arithmetic unpack) matches the reference's
    two's-complement LUT for all 256 byte values, in every unpack flavor."""
    raw = np.arange(256, dtype=np.uint8)
    lut = xengine._TWOS_LUT
    want_i = lut[raw >> 4]
    want_q = lut[raw & 0xF]
    re8, im8 = xengine.unpack_packed_4bit_int8(raw)
    np.testing.assert_array_equal(np.asarray(re8), want_i.astype(np.int8))
    np.testing.assert_array_equal(np.asarray(im8), want_q.astype(np.int8))
    pc = xengine.unpack_packed_4bit_planar(raw)
    np.testing.assert_allclose(np.asarray(pc.re), want_i / 7.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(pc.im), want_q / 7.0, rtol=1e-6)
    z = xengine.unpack_packed_4bit(raw)
    np.testing.assert_allclose(np.asarray(z).real, want_i / 7.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(z).imag, want_q / 7.0, rtol=1e-6)


def test_unpack_char_int8_accepts_lists():
    re8, im8 = xengine.unpack_char_int8([1, -2, 3, -4])
    np.testing.assert_array_equal(np.asarray(re8), [1, 3])
    np.testing.assert_array_equal(np.asarray(im8), [-2, -4])


def test_channel_major_requires_planar():
    from clenabled_tpu.blocks import XEngine

    with pytest.raises(ValueError):
        XEngine(1, 2, 4, planar=False, channel_major=True)


def _gram_ref_int(zr, zi):
    """NumPy int64 oracle of the stacked Gram: gr = zr·zrᵀ + zi·ziᵀ and
    gi = b − bᵀ with b = zi·zrᵀ, accumulated over T per channel."""
    zr = np.asarray(zr, np.int64)
    zi = np.asarray(zi, np.int64)
    gr = np.einsum("ftk,ftl->fkl", zr, zr) + np.einsum("ftk,ftl->fkl", zi, zi)
    b = np.einsum("ftk,ftl->fkl", zi, zr)
    return gr, b - np.swapaxes(b, -1, -2)


def _triangular_ref(g, s, p):
    """xGPU triangular order, written out as loops: baselines (s1 ≥ s2)
    in row order, pol products XX, XY, YX, YY."""
    rows = []
    for s1 in range(s):
        for s2 in range(s1 + 1):
            rows.append([g[:, s1 * p + p0, s2 * p + p1]
                         for p0 in range(p) for p1 in range(p)])
    return np.transpose(np.asarray(rows), (2, 0, 1))       # [F, nb, p²]


def test_stacked_gram_int8_and_bf16_exact_vs_numpy():
    """S=64 dual-pol: the int8 stacked Gram is integer-exact against the
    NumPy int64 oracle; the float outputs (full matrix and triangular
    order) and the bf16 route are exact too, since every sum here stays
    below 2^24."""
    rng = np.random.default_rng(5)
    f, t, s, p = 4, 256, 64, 2
    q = rng.integers(-63, 64, (2, f, t, s * p))
    want_r, want_i = _gram_ref_int(q[0], q[1])
    gr, gi = xengine.xengine_gram_stacked(jnp.asarray(q[0], jnp.int8),
                                          jnp.asarray(q[1], jnp.int8))
    assert gr.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(gr, np.int64), want_r)
    np.testing.assert_array_equal(np.asarray(gi, np.int64), want_i)
    for dt in (jnp.int8, jnp.bfloat16):
        zr, zi = jnp.asarray(q[0], dt), jnp.asarray(q[1], dt)
        full = xengine.xengine_correlate_stacked(
            zr, zi, npol=p, output_format=xengine.CLXCORR_FULL_MATRIX)
        np.testing.assert_array_equal(np.asarray(full.re), want_r)
        np.testing.assert_array_equal(np.asarray(full.im), want_i)
        tri = xengine.xengine_correlate_stacked(zr, zi, npol=p)
        np.testing.assert_array_equal(np.asarray(tri.re),
                                      _triangular_ref(want_r, s, p))
        np.testing.assert_array_equal(np.asarray(tri.im),
                                      _triangular_ref(want_i, s, p))


def test_stacked_gram_sp256_exact_vs_numpy():
    """S=128 dual-pol (S·P = 256), both output formats, integer-exact."""
    rng = np.random.default_rng(7)
    f, t, s, p = 2, 128, 128, 2
    q = rng.integers(-31, 32, (2, f, t, s * p))
    want_r, want_i = _gram_ref_int(q[0], q[1])
    zr8, zi8 = jnp.asarray(q[0], jnp.int8), jnp.asarray(q[1], jnp.int8)
    for fmt, conv in ((xengine.CLXCORR_TRIANGULAR_ORDER,
                       lambda g: _triangular_ref(g, s, p)),
                      (xengine.CLXCORR_FULL_MATRIX, lambda g: g)):
        got = xengine.xengine_correlate_stacked(zr8, zi8, npol=p,
                                                output_format=fmt)
        np.testing.assert_array_equal(np.asarray(got.re), conv(want_r))
        np.testing.assert_array_equal(np.asarray(got.im), conv(want_i))


@pytest.mark.parametrize("t,sp", [(192, 128), (256, 128), (192, 256)])
def test_gram_stacked_int8_shapes_exact(t, sp):
    """The int32 stacked Gram at odd and even integration lengths and at
    S·P = 128 and 256, integer-exact against the NumPy oracle."""
    rng = np.random.default_rng(11)
    f = 3
    q = rng.integers(-127, 128, (2, f, t, sp))
    gr, gi = xengine.xengine_gram_stacked(jnp.asarray(q[0], jnp.int8),
                                          jnp.asarray(q[1], jnp.int8))
    want_r, want_i = _gram_ref_int(q[0], q[1])
    np.testing.assert_array_equal(np.asarray(gr, np.int64), want_r)
    np.testing.assert_array_equal(np.asarray(gi, np.int64), want_i)


@pytest.mark.parametrize("t,sp", [(192, 128), (192, 256)])
def test_correlate_stacked_triangular_int8_exact(t, sp):
    """Triangular-order output of the int8 engine with the 1/127² scale
    applied once: equal to the scaled NumPy oracle to float32 rounding of
    the exact integers (every |G| here is below 2^24, so the int→float
    conversion is exact and only the scale multiply rounds)."""
    rng = np.random.default_rng(13)
    f, p = 3, 2
    s = sp // p
    q = rng.integers(-63, 64, (2, f, t, sp))
    scale = 1.0 / (127.0 * 127.0)
    got = xengine.xengine_correlate_stacked(
        jnp.asarray(q[0], jnp.int8), jnp.asarray(q[1], jnp.int8), npol=p,
        scale=scale)
    want_r, want_i = _gram_ref_int(q[0], q[1])
    np.testing.assert_array_equal(
        np.asarray(got.re),
        _triangular_ref(want_r, s, p).astype(np.float32) * np.float32(scale))
    np.testing.assert_array_equal(
        np.asarray(got.im),
        _triangular_ref(want_i, s, p).astype(np.float32) * np.float32(scale))
