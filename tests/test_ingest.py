"""Host-ingest pipeline (streaming/ingest.py) and frame batching
(accumulate_frames on the correlator blocks).

The reference's end-to-end path is a pinned double-buffered host feed
(lib/clXEngine_impl.cc:325-366) and its FD correlator dispatches one
analysis window per work() call; ours overlaps device_put with compute via
a prefetch thread and batches N windows per device dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clenabled_tpu import blocks
from clenabled_tpu.streaming.graph import Flowgraph
from clenabled_tpu.streaming.ingest import HostIngest


def test_host_ingest_matches_sequential():
    """HostIngest drives a carried-state step identically to a plain loop."""
    n = 1024

    @jax.jit
    def step(carry, x):
        s = carry + jnp.sum(x)
        return s, s * 2.0

    rng = np.random.default_rng(0)
    frames = [rng.standard_normal(n).astype(np.float32) for _ in range(7)]

    expect = np.float32(0.0)
    for f in frames:
        expect = expect + f.sum()

    outs = []
    ing = HostIngest(step, jnp.float32(0.0), samples_per_frame=n,
                     prefetch=2, fetch_every=1)
    stats = ing.run(iter(frames), on_outputs=lambda i, o: outs.append(o))
    assert stats["steps"] == 7
    assert stats["samples"] == 7 * n
    assert stats["wall_s"] > 0 and stats.msps > 0
    np.testing.assert_allclose(np.asarray(outs[-1]), expect * 2.0, rtol=1e-4)


def test_host_ingest_tuple_frames_and_nsteps():
    @jax.jit
    def step(carry, a, b):
        return carry + 1, jnp.sum(a) + jnp.sum(b)

    frames = [(np.ones(8, np.float32), np.ones(8, np.float32))
              for _ in range(5)]
    ing = HostIngest(step, jnp.int32(0), samples_per_frame=8)
    stats = ing.run(iter(frames), n_steps=3)
    assert stats["steps"] == 3


def _run_xcorr(accumulate, decim=1, n=1024, shift=64, n_frames=6, seed=3):
    """Drive XCorrelate over n_frames windows, return per-window messages."""
    xc = blocks.XCorrelate(2, signal_length=n, max_search_index=shift,
                           decim_frames=decim, accumulate_frames=accumulate)
    g = Flowgraph()
    g.external_input(xc, 0)
    g.external_input(xc, 1)
    r = g.compile(frame_size=n * accumulate)
    msgs = []
    r.on_message("xcorr.corr", lambda m: msgs.append(
        jax.tree.map(np.asarray, m)))
    rng = np.random.default_rng(seed)
    delay = 17
    base = rng.standard_normal(n_frames * n + 256).astype(np.float32)
    a = base[128:128 + n_frames * n]
    b = base[128 - delay:128 - delay + n_frames * n]
    for s in range(0, n_frames, accumulate):
        r.step(a[s * n:(s + accumulate) * n], b[s * n:(s + accumulate) * n])
    # flatten to per-window (corr, lag, valid)
    wins = []
    for m in msgs:
        c, l, v = m["corr"], m["corrective_lags"], m["valid"]
        if accumulate == 1:
            wins.append((float(c[0]), int(l[0]), bool(v)))
        else:
            for w in range(accumulate):
                wins.append((float(c[w, 0]), int(l[w, 0]), bool(v[w])))
    return wins, delay


def test_xcorrelate_accumulate_frames_matches_single():
    """N windows per dispatch gives the same per-window results as 1."""
    one, delay = _run_xcorr(accumulate=1)
    three, _ = _run_xcorr(accumulate=3)
    assert len(one) == len(three) == 6
    for (c1, l1, v1), (c3, l3, v3) in zip(one, three):
        assert v1 and v3
        assert l1 == l3 == -delay
        np.testing.assert_allclose(c1, c3, rtol=1e-4)


def test_xcorrelate_accumulate_with_decimation():
    """1-in-N frame decimation stays window-indexed across batched calls."""
    wins, _ = _run_xcorr(accumulate=3, decim=2)
    assert [v for (_, _, v) in wins] == [True, False] * 3


def test_fd_xcorr_accumulate_frames_quantum_and_parity():
    """accumulate_frames=N feeds N vectors per step; outputs identical."""
    fft_size, nfr = 256, 4
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, nfr * fft_size))
         + 1j * rng.standard_normal((2, nfr * fft_size))).astype(np.complex64)

    def run(accumulate):
        blk = blocks.XCorrelateFFTVCF(fft_size, 2, input_type=2,
                                      accumulate_frames=accumulate)
        assert blk.quantum == fft_size * accumulate
        g = Flowgraph()
        g.external_input(blk, 0)
        g.external_input(blk, 1)
        tap = g.tap(blk)
        r = g.compile(frame_size=blk.quantum)
        outs = []
        for s in range(0, nfr * fft_size, blk.quantum):
            outs.append(np.asarray(
                r.step(x[0, s:s + blk.quantum],
                       x[1, s:s + blk.quantum])[tap]))
        return np.concatenate(outs)

    np.testing.assert_allclose(run(1), run(4), rtol=1e-4, atol=1e-5)


def test_xcorrelate_planar_batched_matches_complex():
    """td_xcorr_planar_batched == td_xcorr_batched on |complex| windows."""
    from clenabled_tpu.dsp import xcorr as dsp_xcorr

    rng = np.random.default_rng(11)
    sig = (rng.standard_normal((3, 2, 512))
           + 1j * rng.standard_normal((3, 2, 512))).astype(np.complex64)
    ref = dsp_xcorr.td_xcorr_batched(jnp.asarray(sig), 32)
    got = dsp_xcorr.td_xcorr_planar_batched(jnp.abs(jnp.asarray(sig)), 32)
    np.testing.assert_allclose(np.asarray(got.corr_vectors),
                               np.asarray(ref.corr_vectors),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.lag), np.asarray(ref.lag))
