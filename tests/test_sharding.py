"""Sharded == sequential: the halo-exchange filters and the all_to_all
X-Engine must reproduce single-device results on the 8-device CPU mesh."""

import numpy as np
import pytest

from clenabled_tpu.dsp import fft_filter, fir_filter, firdes, channelizer, xengine
from clenabled_tpu.sharding import (
    make_mesh,
    make_sharded_fft_filter,
    make_sharded_fir_filter,
    make_sharded_channelizer,
    make_sharded_xengine,
    sharded_xengine,
)

RNG = np.random.default_rng(31)


def cplx(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(
        np.complex64
    )


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.shape["shard"] == 8


def test_sharded_fir_matches_sequential():
    mesh = make_mesh()
    taps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    init_s, apply_s = make_sharded_fir_filter(taps, mesh)
    init_q, apply_q = fir_filter.make_fir_filter(taps)
    n = 8 * 512
    state_s, state_q = init_s(), init_q()
    for frame_i in range(3):
        x = cplx(n)
        state_s, ys = apply_s(state_s, x)
        state_q, yq = apply_q(state_q, x)
        np.testing.assert_allclose(np.asarray(ys), np.asarray(yq),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"frame {frame_i}")


def test_sharded_fir_with_decimation():
    mesh = make_mesh()
    taps = firdes.low_pass(1.0, 1e6, 50e3, 25e3)
    init_s, apply_s = make_sharded_fir_filter(taps, mesh, decimation=4)
    init_q, apply_q = fir_filter.make_fir_filter(taps, decimation=4)
    n = 8 * 1024
    x = cplx(n)
    _, ys = apply_s(init_s(), x)
    _, yq = apply_q(init_q(), x)
    assert ys.shape == (n // 4,)
    np.testing.assert_allclose(np.asarray(ys), np.asarray(yq), rtol=1e-5, atol=1e-5)


def test_sharded_ofa_matches_sequential():
    mesh = make_mesh()
    taps = firdes.root_raised_cosine(1.0, 10e6, 1e6, 0.22, 241)
    init_s, apply_s, plan = make_sharded_fft_filter(taps, mesh)
    init_q, apply_q, _ = fft_filter.make_fft_filter(taps)
    n = 8 * plan.nsamples * 4  # per-shard: 4 chunks
    state_s, state_q = init_s(), init_q()
    for frame_i in range(3):
        x = cplx(n)
        state_s, ys = apply_s(state_s, x)
        state_q, yq = apply_q(state_q, x)
        np.testing.assert_allclose(np.asarray(ys), np.asarray(yq),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"frame {frame_i}")


def test_sharded_ofa_bad_block_raises():
    mesh = make_mesh()
    taps = firdes.low_pass(1.0, 1e6, 100e3, 20e3)
    init_s, apply_s, plan = make_sharded_fft_filter(taps, mesh)
    with pytest.raises(ValueError):
        apply_s(init_s(), cplx(8 * (plan.nsamples + 1)))


@pytest.mark.parametrize("m,r", [(8, 8), (8, 4)])
def test_sharded_channelizer_matches_sequential(m, r):
    mesh = make_mesh()
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    init_s, apply_s = make_sharded_channelizer(taps, m, r, list(range(m)), mesh)
    init_q, apply_q = channelizer.make_channelizer(taps, m, r, list(range(m)))
    n = 8 * 16 * m
    state_s, state_q = init_s(), init_q()
    for frame_i in range(2):
        x = cplx(n)
        state_s, ys = apply_s(state_s, x)
        state_q, yq = apply_q(state_q, x)
        np.testing.assert_allclose(np.asarray(ys), np.asarray(yq),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"frame {frame_i}")


def test_sharded_xengine_matches_sequential():
    mesh = make_mesh()
    t, s, f, p = 16, 8, 16, 2
    z = cplx(t, s, f, p)
    got = np.asarray(sharded_xengine(z, mesh))
    want = np.asarray(xengine.xengine_correlate(z, npol=p))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_xengine_streaming_pipeline():
    mesh = make_mesh()
    t, s, f, p = 8, 8, 8, 2
    init_s, apply_s = make_sharded_xengine(s, f, p, t, mesh,
                                           pipeline_integration=2)
    init_q, apply_q = xengine.make_xengine(s, f, p, t, pipeline_integration=2)
    state_s, state_q = init_s(), init_q()
    for i in range(2):
        z = cplx(t, s, f, p)
        state_s, (out_s, ready_s) = apply_s(state_s, z)
        state_q, (out_q, ready_q) = apply_q(state_q, z)
        assert bool(ready_s) == bool(ready_q) == (i == 1)
        np.testing.assert_allclose(np.asarray(out_s), np.asarray(out_q),
                                   rtol=1e-4, atol=1e-4)


def test_sharded_xengine_validates_divisibility():
    mesh = make_mesh()
    with pytest.raises(ValueError):
        sharded_xengine(cplx(4, 6, 16, 2), mesh)  # 6 stations !% 8


def test_sharded_planar_ofa_matches_sequential():
    from clenabled_tpu.dsp import planar
    from clenabled_tpu.sharding import make_sharded_fft_filter_planar

    mesh = make_mesh()
    taps = firdes.root_raised_cosine(1.0, 10e6, 1e6, 0.22, 241)
    init_s, apply_s = make_sharded_fft_filter_planar(taps, mesh)
    init_q, apply_q, plan = fft_filter.make_fft_filter(taps)
    n = 8 * plan.nsamples * 2
    state_s, state_q = init_s(), init_q()
    for i in range(2):
        x = cplx(n)
        state_s, ys = apply_s(state_s, planar.from_complex(x))
        state_q, yq = apply_q(state_q, x)
        got = np.asarray(ys.re) + 1j * np.asarray(ys.im)
        np.testing.assert_allclose(got, np.asarray(yq), rtol=1e-3, atol=1e-3,
                                   err_msg=f"frame {i}")


def test_sharded_planar_xengine_matches():
    from clenabled_tpu.dsp import planar
    from clenabled_tpu.sharding import sharded_xengine_planar

    mesh = make_mesh()
    t, s, f, p = 8, 8, 16, 2
    z = cplx(t, s, f, p)
    got_pc = sharded_xengine_planar(planar.from_complex(z), mesh, npol=p)
    got = np.asarray(got_pc.re) + 1j * np.asarray(got_pc.im)
    want = np.asarray(xengine.xengine_correlate(z, npol=p))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_planar_channelizer_matches_sequential():
    from clenabled_tpu.dsp import planar
    from clenabled_tpu.sharding import make_sharded_channelizer_planar

    mesh = make_mesh()
    m, r = 8, 4
    taps = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    init_s, apply_s = make_sharded_channelizer_planar(
        taps, m, r, list(range(m)), mesh)
    init_q, apply_q = channelizer.make_channelizer(taps, m, r, list(range(m)))
    n = 8 * 16 * m
    state_s, state_q = init_s(), init_q()
    for i in range(2):
        x = cplx(n)
        state_s, ys = apply_s(state_s, planar.from_complex(x))
        state_q, yq = apply_q(state_q, x)
        got = np.asarray(ys.re) + 1j * np.asarray(ys.im)
        np.testing.assert_allclose(got, np.asarray(yq), rtol=1e-3, atol=1e-3,
                                   err_msg=f"frame {i}")


def test_sharded_chain_matches_sequential_flowgraph():
    """ShardedChain(LPF -> scale -> quad demod) == the sequential chain."""
    from clenabled_tpu.sharding import ShardedChain
    from clenabled_tpu.dsp import demod as dsp_demod

    mesh = make_mesh()
    taps = firdes.low_pass(1.0, 1e6, 100e3, 20e3)
    chain = (ShardedChain(mesh)
             .add_fft_filter(taps)
             .add_map(lambda x: x * 2.0)
             .add_quadrature_demod(0.7))
    init, step = chain.compile()

    # sequential reference
    iq, aq, plan = fft_filter.make_fft_filter(taps)
    n = 8 * plan.nsamples * 2
    state_s = init()
    state_f = iq()
    last = None
    for i in range(3):
        x = cplx(n)
        state_s, ys = step(state_s, x)
        state_f, yf = aq(state_f, x)
        yf = np.asarray(yf) * 2.0
        yq, last = dsp_demod.quadrature_demod(yf, 0.7, last_sample=last)
        np.testing.assert_allclose(np.asarray(ys), np.asarray(yq),
                                   rtol=1e-3, atol=1e-3,
                                   err_msg=f"frame {i}")


def test_sharded_chain_with_channelizer():
    from clenabled_tpu.sharding import ShardedChain

    mesh = make_mesh()
    m = 8
    proto = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    chain = ShardedChain(mesh).add_channelizer(proto, m, m, list(range(m)))
    init, step = chain.compile()
    n = 8 * 16 * m
    x = cplx(n)
    _, out = step(init(), x)
    iq, aq = channelizer.make_channelizer(proto, m, m, list(range(m)))
    _, want = aq(iq(), x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _flagship_pair(dt, n_local, d, mesh, a=4, m=16):
    from clenabled_tpu.pipelines import (FxPipelineConfig,
                                         make_fx_pipeline_planar,
                                         make_sharded_fx_pipeline)

    cfg_s = FxPipelineConfig(num_antennas=a, num_channels=m,
                             samples_per_step=n_local)
    cfg_1 = cfg_s._replace(samples_per_step=n_local * d)
    fn_s, args_s = make_sharded_fx_pipeline(mesh, cfg=cfg_s, in_dtype=dt)
    fn_1, args_1 = make_fx_pipeline_planar(cfg_1, in_dtype=dt)
    return fn_s, args_s, fn_1, args_1


def test_sharded_flagship_matches_single_device():
    """The time-sharded planar flagship (ring-ppermute channelizer halo,
    psum-reduced correlation sums and Gram) reproduces the one-device
    flagship over the concatenated stream — two steps, so the carried
    history crosses both the shard ring and the step boundary."""
    mesh = make_mesh()
    d = mesh.shape["shard"]
    n_local = 1024
    fn_s, (xr0, _, hr_s, hi_s), fn_1, (_, _, hr_1, hi_1) = _flagship_pair(
        np.float32, n_local, d, mesh)
    assert xr0.shape == (4, n_local * d)
    for k in range(2):
        xr = RNG.standard_normal((4, n_local * d)).astype(np.float32)
        xi = RNG.standard_normal((4, n_local * d)).astype(np.float32)
        got = fn_s(xr, xi, hr_s, hi_s)
        want = fn_1(xr, xi, hr_1, hi_1)
        for g, w, name in zip(got, want, ("fd", "xre", "xim", "hr", "hi")):
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"step {k} {name}")
        hr_s, hi_s = got[3:]
        hr_1, hi_1 = want[3:]


@pytest.mark.parametrize("dt_name", ["int8", "bfloat16"])
def test_sharded_flagship_narrow_ingest(dt_name):
    """Sharded flagship with bf16/int8 ingest (the reference's IChar
    path, lib/clXEngine_impl.cc:831-858): the narrow samples are widened
    on each device and the result equals the one-device flagship in the
    same dtype."""
    import jax.numpy as jnp

    dt = jnp.dtype(dt_name)
    mesh = make_mesh()
    d = mesh.shape["shard"]
    n_local = 512
    fn_s, (xr0, _, hr, hi), fn_1, _ = _flagship_pair(dt, n_local, d, mesh)
    assert xr0.dtype == dt
    rng = np.random.default_rng(5)
    q = rng.integers(-16, 17, (2, 4, n_local * d))
    xr, xi = jnp.asarray(q[0], dt), jnp.asarray(q[1], dt)
    got = fn_s(xr, xi, hr, hi)
    want = fn_1(xr, xi, hr, hi)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("dt_name", ["float32", "int8"])
def test_sharded_stacked_xengine_matches_single_device(dt_name):
    """make_sharded_xengine_stacked (all_to_all lane->channel re-shard +
    per-chip stacked Gram) == the unsharded stacked engine, including
    pipeline-integration emission and int8 exact accumulation."""
    import jax.numpy as jnp

    from clenabled_tpu.sharding import make_sharded_xengine_stacked

    mesh = make_mesh()
    d = mesh.shape["shard"]
    s, p, f, t = 2 * d, 2, 2 * d, 16
    sp = s * p
    rng = np.random.default_rng(3)
    scale = 1.0 / (127.0 * 127.0) if dt_name == "int8" else 1.0
    init_s, apply_s = make_sharded_xengine_stacked(
        s, f, p, t, mesh, pipeline_integration=2, scale=scale)
    init_q, apply_q = xengine.make_xengine_channel_major(
        s, f, p, t, pipeline_integration=2, scale=scale)
    st_s, st_q = init_s(), init_q()
    for k in range(4):
        if dt_name == "int8":
            zr = rng.integers(-127, 128, (f, t, sp)).astype(np.int8)
            zi = rng.integers(-127, 128, (f, t, sp)).astype(np.int8)
        else:
            zr = rng.standard_normal((f, t, sp)).astype(np.float32)
            zi = rng.standard_normal((f, t, sp)).astype(np.float32)
        st_s, (out_s, ready_s) = apply_s(st_s, (jnp.asarray(zr),
                                                jnp.asarray(zi)))
        st_q, (out_q, ready_q) = apply_q(st_q, (jnp.asarray(zr),
                                                jnp.asarray(zi)))
        assert bool(ready_s) == bool(ready_q) == (k % 2 == 1)
        np.testing.assert_allclose(np.asarray(out_s.re), np.asarray(out_q.re),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(out_s.im), np.asarray(out_q.im),
                                   rtol=1e-5, atol=1e-4)


def _sharded_vs_single_channelizer(taps, m, r, d, local, seed):
    import jax
    from jax.sharding import Mesh

    from clenabled_tpu.dsp import planar
    from clenabled_tpu.sharding import make_sharded_channelizer_planar

    mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
    n = d * local
    rng = np.random.default_rng(seed)
    init_s, apply_s = make_sharded_channelizer_planar(
        taps, m, r, list(range(m)), mesh)
    init_1, apply_1 = channelizer.make_channelizer(taps, m, r, list(range(m)),
                                                   planar=True)
    st_s, st_1 = init_s(), init_1()
    for frame in range(2):
        fr = planar.PC(rng.standard_normal(n).astype(np.float32),
                       rng.standard_normal(n).astype(np.float32))
        st_s, out_s = apply_s(st_s, fr)
        st_1, out_1 = apply_1(st_1, fr)
        got = np.asarray(out_s.re) + 1j * np.asarray(out_s.im)
        want = np.asarray(out_1.re) + 1j * np.asarray(out_1.im)
        np.testing.assert_allclose(got.reshape(want.shape), want,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=f"frame {frame}")


def test_sharded_oversampled_channelizer_matches_streaming():
    """Time-sharded oversampled planar PFB (16 channels, R=8, ring-ppermute
    halo) == the one-device streaming channelizer on the concatenated
    stream, across 2 frames (carried state through the ring)."""
    taps = firdes.low_pass(1.0, 16.0, 0.5, 0.25)
    _sharded_vs_single_channelizer(taps, 16, 8, 4, 2048, 3)


def test_sharded_costas_channels_matches_single_chip():
    """Channel-parallel chunked Costas over the mesh == the same chunked
    loop run per channel on one device (no cross-chip math in the path)."""
    import jax
    from jax.sharding import Mesh

    from clenabled_tpu.dsp import demod, planar
    from clenabled_tpu.sharding import make_sharded_costas_channels

    d, c, n = 4, 8, 2048
    chunk, warmup = 512, 256
    mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
    rng = np.random.default_rng(4)
    ph = 0.004 * np.arange(n)[None, :] + rng.uniform(0, 6, (c, 1))
    x = planar.PC(np.cos(ph).astype(np.float32),
                  np.sin(ph).astype(np.float32))

    init_s, apply_s = make_sharded_costas_channels(
        0.02, 2, mesh, chunk=chunk, warmup=warmup)
    st = init_s(c)
    st, out, diag = apply_s(st, x)

    run1 = demod.make_costas_loop_chunked(0.02, 2, chunk=chunk,
                                          warmup=warmup)
    for ch in range(c):
        s1 = run1.init_state()
        s1, o1, d1 = run1(s1, planar.PC(x.re[ch], x.im[ch]))
        np.testing.assert_array_equal(np.asarray(out.re)[ch],
                                      np.asarray(o1.re))
        np.testing.assert_array_equal(np.asarray(out.im)[ch],
                                      np.asarray(o1.im))
        np.testing.assert_allclose(float(np.asarray(diag["residual"])[ch]),
                                   float(d1["residual"]), rtol=1e-6, atol=0)


def test_sharded_oversampled_channelizer_deep_halo():
    """Sharded oversampled PFB with a long prototype (more than 1024 taps
    at M=64, R=16): the ring ppermute exchanges the longer ntaps−1 halo;
    parity vs one device."""
    taps = firdes.low_pass(1.0, 64.0, 0.5, 0.08)
    assert len(taps) > 1024
    _sharded_vs_single_channelizer(taps, 64, 16, 2, 4096, 8)


def test_sharded_xengine_stacked_int8_exact_vs_numpy():
    """The sharded stacked X-Engine at S·P = 128 (station→channel
    all_to_all) is integer-exact against a NumPy int64 Gram, in full
    matrix and triangular order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from clenabled_tpu.sharding import make_sharded_xengine_stacked

    d = 2
    mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
    s, p, f, t = 64, 2, 4, 128
    rng = np.random.default_rng(6)
    q = rng.integers(-31, 32, (2, f, t, s * p)).astype(np.int64)
    b = np.einsum("ftk,ftl->fkl", q[1], q[0])
    want_r = (np.einsum("ftk,ftl->fkl", q[0], q[0])
              + np.einsum("ftk,ftl->fkl", q[1], q[1]))
    want_i = b - np.swapaxes(b, -1, -2)
    rows, cols = zip(*[(s1 * p + p0, s2 * p + p1)
                       for s1 in range(s) for s2 in range(s1 + 1)
                       for p0 in range(p) for p1 in range(p)])
    zr, zi = jnp.asarray(q[0], jnp.int8), jnp.asarray(q[1], jnp.int8)
    for fmt in (xengine.CLXCORR_FULL_MATRIX, xengine.CLXCORR_TRIANGULAR_ORDER):
        init, apply = make_sharded_xengine_stacked(s, f, p, t, mesh,
                                                   output_format=fmt)
        _, (out, ready) = apply(init(), (zr, zi))
        assert bool(np.asarray(ready))
        if fmt == xengine.CLXCORR_FULL_MATRIX:
            wr, wi = want_r, want_i
        else:
            wr = want_r[:, rows, cols].reshape(f, -1, p * p)
            wi = want_i[:, rows, cols].reshape(f, -1, p * p)
        np.testing.assert_array_equal(np.asarray(out.re), wr)
        np.testing.assert_array_equal(np.asarray(out.im), wi)


def test_sharded_planar_ofa_decimation_matches_single_device():
    """The sharded planar overlap-add filter (additive output-tail ring
    halo) equals the one-device planar filter across frames, for
    decimation 1 and 2."""
    import jax
    from jax.sharding import Mesh

    from clenabled_tpu.dsp import planar
    from clenabled_tpu.sharding import make_sharded_fft_filter_planar

    taps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    d = 4
    mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
    rng = np.random.default_rng(10)
    for decim in (1, 2):
        init_s, apply_s = make_sharded_fft_filter_planar(
            taps, mesh, decimation=decim)
        init_1, apply_1, plan = fft_filter.make_fft_filter_planar(
            taps, decimation=decim)
        local = fft_filter.frame_quantum(plan) * 4
        n = d * local
        ss, s1 = init_s(), init_1()
        for frame in range(2):
            fr = planar.PC(rng.standard_normal(n).astype(np.float32),
                           rng.standard_normal(n).astype(np.float32))
            ss, ys = apply_s(ss, fr)
            s1, y1 = apply_1(s1, fr)
            np.testing.assert_allclose(
                np.asarray(ys.re), np.asarray(y1.re), atol=2e-4,
                err_msg=f"decim {decim} frame {frame}")
            np.testing.assert_allclose(
                np.asarray(ys.im), np.asarray(y1.im), atol=2e-4,
                err_msg=f"decim {decim} frame {frame}")


def test_sharded_td_xcorr_matches_single_device():
    """Window-parallel TD lag scan over the
    mesh == the single-device planar scan, bit-for-bit (pure data
    parallelism, no collectives)."""
    from clenabled_tpu.dsp import xcorr
    from clenabled_tpu.sharding import make_sharded_td_xcorr

    mesh = make_mesh()
    max_shift = 64
    apply = make_sharded_td_xcorr(mesh, max_shift)
    nsig, b, n = 3, 16, 1024
    mags = np.abs(cplx(nsig, b, n)).astype(np.float32)
    got = apply(mags)
    want = xcorr.td_xcorr_planar_batched(mags, max_shift)
    np.testing.assert_array_equal(np.asarray(got.corr), np.asarray(want.corr))
    np.testing.assert_array_equal(np.asarray(got.lag), np.asarray(want.lag))
    np.testing.assert_array_equal(np.asarray(got.corr_vectors),
                                  np.asarray(want.corr_vectors))
    with pytest.raises(ValueError, match="multiple"):
        apply(mags[:, :9])


def test_sharded_fd_xcorr_matches_single_device():
    from clenabled_tpu.dsp import planar, xcorr
    from clenabled_tpu.sharding import make_sharded_fd_xcorr

    mesh = make_mesh()
    nsig, b, n = 4, 8, 512
    z = cplx(nsig, b, n)
    v = planar.PC(np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag))
    for fft_first in (False, True):
        apply = make_sharded_fd_xcorr(mesh, perform_fft_first=fft_first)
        got = apply(v)
        want = np.asarray(xcorr.fd_xcorr_planar(
            v, perform_fft_first=fft_first))
        # sharding changes the DFT-matmul batch grouping → fp-order noise
        np.testing.assert_allclose(np.asarray(got), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())
