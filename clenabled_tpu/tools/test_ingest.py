"""End-to-end host-ingest benchmark for the flagship pipeline.

The reference's sustained numbers are end-to-end through its pinned
double-buffered host feed (lib/clXEngine_impl.cc:325-366); this tool
measures the equivalent here for the planar flagship and separates the
three rates that bound it:

  link   — raw host→device bandwidth for the frame arrays alone
  device — the flagship step consuming device-resident frames
  e2e    — HostIngest pipeline: prefetch-threaded device_put feeding the
           kernel, wall-clocked around everything

Sustained end-to-end throughput = min(link, device) when the feed and the
compute overlap; a shortfall below that min is pipeline loss.  Narrow
ingest (int8 = the reference's IChar format) quarters the link bytes per
sample, which is why it suits link-bound setups.

Usage: python -m clenabled_tpu.tools.test_ingest [--cpu] [--steps N]
           [--samples-per-step LOG2] [--dtype f32|int8|both]
"""

from __future__ import annotations

import argparse
import time


def _bench_dtype(in_dtype_name: str, n_log2: int, steps: int) -> None:
    import jax
    import numpy as np

    from clenabled_tpu.pipelines import (FxPipelineConfig,
                                         make_fx_pipeline_planar)
    from clenabled_tpu.streaming.ingest import HostIngest

    jnp_dtype = {"f32": np.float32, "int8": np.int8}[in_dtype_name]
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << n_log2)
    fn, (xr, xi, tr, ti) = make_fx_pipeline_planar(cfg, in_dtype=jnp_dtype)
    a, n = xr.shape
    dev = jax.devices()[0]

    rng = np.random.default_rng(0)
    if jnp_dtype == np.int8:
        frames = [(rng.integers(-100, 100, (a, n), dtype=np.int8),
                   rng.integers(-100, 100, (a, n), dtype=np.int8))
                  for _ in range(4)]
    else:
        frames = [(rng.standard_normal((a, n)).astype(np.float32),
                   rng.standard_normal((a, n)).astype(np.float32))
                  for _ in range(4)]
    frame_bytes = frames[0][0].nbytes * 2

    # 1) link-only: host clock around `steps` puts, ended by
    # block_until_ready
    jax.block_until_ready([jax.device_put(f, dev) for f in frames[0]])
    t0 = time.perf_counter()
    ups = [[jax.device_put(f, dev) for f in frames[i % len(frames)]]
           for i in range(steps)]
    jax.block_until_ready(ups)
    link_s = (time.perf_counter() - t0) / steps
    del ups
    link_gbs = frame_bytes / link_s / 1e9
    link_msps = n / link_s / 1e6

    # 2) device-only: tail-chained steady state on device-resident frames
    dr = jax.device_put(frames[0][0], dev)
    di = jax.device_put(frames[0][1], dev)
    jax.block_until_ready(fn(dr, di, tr, ti))
    t0 = time.perf_counter()
    ctr, cti = tr, ti
    for _ in range(steps):
        fd, xre, xim, ctr, cti = fn(dr, di, ctr, cti)
    jax.block_until_ready((fd, xre, xim, ctr, cti))
    dev_s = (time.perf_counter() - t0) / steps
    dev_msps = n / dev_s / 1e6

    # 3) end-to-end through HostIngest
    def step(carry, fr, fi):
        fd, xre, xim, ntr, nti = fn(fr, fi, carry[0], carry[1])
        return (ntr, nti), (fd, xre, xim)

    step = jax.jit(step)
    ing = HostIngest(step, (tr, ti), samples_per_frame=n, prefetch=2)
    # warm the jit before timing
    ing.run(iter(frames[:1]))
    ing = HostIngest(step, (tr, ti), samples_per_frame=n, prefetch=2)
    stats = ing.run((frames[i % len(frames)] for i in range(steps)))
    e2e_msps = stats.msps
    eff = e2e_msps / min(link_msps, dev_msps) * 100

    print(f"[{in_dtype_name}] frame {n>>20}Mi samples/ant x{a} "
          f"({frame_bytes/1e6:.0f} MB)")
    print(f"  link  h2d      {link_gbs:7.3f} GB/s = {link_msps:10.1f} MSPS")
    print(f"  device step    {dev_s*1e3:7.2f} ms   = {dev_msps:10.1f} MSPS")
    print(f"  end-to-end     {stats['wall_s']/stats['steps']*1e3:7.2f} ms   "
          f"= {e2e_msps:10.1f} MSPS  ({eff:.0f}% of min(link, device))")


def _bench_packed4(n_log2: int, steps: int, write_disk: bool) -> None:
    """The link-bound ingest story as one path (the reference's whole reason for IChar/packed modes,
    lib/clXEngine_impl.cc:325-366, 831-858):

        packed-4bit tagged frames (1 byte per complex sample — 1/8 the
        f32 wire bytes) → SynchronizedIngest tag alignment (incl. one
        injected mid-stream drop + re-sync) → HostIngest prefetch →
        on-device gather-free nibble unpack → int8 flagship →
        X-Engine products → RollingFileWriter disk sidecar output.
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    from clenabled_tpu.dsp import xengine
    from clenabled_tpu.pipelines import (FxPipelineConfig,
                                         make_fx_pipeline_planar)
    from clenabled_tpu.streaming.ingest import HostIngest
    from clenabled_tpu.streaming.sync import SynchronizedIngest, TaggedFrame

    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << n_log2)
    fn, (xr, xi, tr, ti) = make_fx_pipeline_planar(cfg, in_dtype=np.int8)
    a, n = xr.shape

    rng = np.random.default_rng(0)
    pool = [rng.integers(0, 256, (a, n), dtype=np.uint8) for _ in range(4)]
    frame_bytes = pool[0].nbytes

    # per-antenna tagged capture streams; antenna 2 drops frame 3 to
    # exercise the re-sync path mid-benchmark
    def source(ant):
        skew = ant  # staggered start timestamps force initial alignment
        for ts in range(skew, steps + 8):
            if ant == 2 and ts == 3 + skew:
                continue
            yield TaggedFrame(ts, pool[ts % len(pool)][ant])

    events = []
    sync = SynchronizedIngest([source(i) for i in range(a)],
                              block_multiple=2,
                              on_sync=lambda ts: events.append(("sync", ts)),
                              on_resync=lambda o, t: events.append(
                                  ("resync", o, t)))
    stacked = (np.stack(f) for f in sync)   # [A, n] packed bytes per step

    writer = None
    if write_disk:
        import json
        import tempfile

        from clenabled_tpu import native

        tmp = tempfile.mkdtemp(prefix="clen_xcorr_")
        sidecar = json.dumps({"antennas": a, "channels": cfg.num_channels,
                              "format": "triangular order", "dtype": "f32"})
        writer = native.RollingFileWriter(f"{tmp}/xcorr", 1 << 22, sidecar)

    def step(carry, raw):
        re8, im8 = xengine.unpack_packed_4bit_int8(raw)   # on-device
        fd, xre, xim, ntr, nti = fn(re8, im8, carry[0], carry[1])
        return (ntr, nti), (fd, xre, xim)

    step = jax.jit(step)
    tz = jnp.zeros_like(tr)
    ing = HostIngest(step, (tz, jnp.zeros_like(ti)), samples_per_frame=n,
                     prefetch=2)
    ing.run(iter([pool[0]]))                 # warm the jit off the clock

    # sustained-window instrumentation: per-step completion timestamps + time spent inside the disk writer,
    # so the report separates burst from sustained and shows the writer
    # never falls behind (writes are synchronous here — "backlog" shows
    # up as write stall time, not dropped frames)
    marks = []
    wstall = [0.0]
    wbytes = [0]

    def on_outputs(step_no, fetched):
        if writer is not None:
            fd, xre, xim = fetched
            buf = np.ascontiguousarray(np.stack([xre, xim]))
            t0 = time.perf_counter()
            writer.write(buf)
            wstall[0] += time.perf_counter() - t0
            wbytes[0] += buf.nbytes
        marks.append(time.perf_counter())

    ing = HostIngest(step, (tz, jnp.zeros_like(ti)), samples_per_frame=n,
                     prefetch=2, fetch_every=1)
    stats = ing.run(stacked, n_steps=steps, on_outputs=on_outputs)
    if writer is not None:
        writer.close()
    msps = stats.msps
    gbs = stats["steps"] * frame_bytes / stats["wall_s"] / 1e9
    print(f"[packed4] frame {n>>20}Mi samples/ant x{a} "
          f"({frame_bytes/1e6:.0f} MB wire = 1/8 of f32)")
    print(f"  sync events    {events}")
    print(f"  end-to-end     {stats['wall_s']/stats['steps']*1e3:7.2f} ms   "
          f"= {msps:10.1f} MSPS/ant  ({gbs:.3f} GB/s wire"
          f"{', disk on' if write_disk else ''})")
    if len(marks) >= 8:
        qs = len(marks) // 4
        for qi in range(4):
            lo = qi * qs
            hi = (qi + 1) * qs if qi < 3 else len(marks) - 1
            dt = marks[hi] - marks[lo]
            nsteps = hi - lo
            print(f"  quarter {qi + 1}      {nsteps * n / dt / 1e6:10.1f} "
                  f"MSPS/ant over {dt:6.1f} s")
    if writer is not None:
        print(f"  writer         {wbytes[0] / 1e6:.3f} MB written, "
              f"{wstall[0]:.2f} s in write() "
              f"({100 * wstall[0] / stats['wall_s']:.1f}% of wall), "
              f"0 frames dropped (synchronous writes)")
    print(f"  steps          {stats['steps']} over {stats['wall_s']:.1f} s "
          f"wall")


def main() -> None:
    ap = argparse.ArgumentParser(description="host-ingest flagship benchmark")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--samples-per-step", type=int, default=22,
                    help="log2 samples per antenna per step")
    ap.add_argument("--dtype", choices=["f32", "int8", "both"],
                    default="both")
    ap.add_argument("--packed4", action="store_true",
                    help="the link-bound path: packed-4bit frames -> "
                    "SynchronizedIngest -> HostIngest -> int8 flagship -> "
                    "rolling disk")
    ap.add_argument("--no-disk", action="store_true",
                    help="with --packed4: skip the RollingFileWriter leg")
    args = ap.parse_args()

    from clenabled_tpu.tools import _timing as T
    T.select_platform(args)
    print(f"platform: {T.platform_banner()}")
    if args.packed4:
        _bench_packed4(args.samples_per_step, args.steps, not args.no_disk)
        return
    names = ["f32", "int8"] if args.dtype == "both" else [args.dtype]
    for nm in names:
        _bench_dtype(nm, args.samples_per_step, args.steps)


if __name__ == "__main__":
    main()
