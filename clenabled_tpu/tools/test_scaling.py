"""Multi-device scaling benchmark — the measurement the north star asks for
(≥80% scaling efficiency): runs the SHARDED flagship pipeline over meshes of
1..N devices and reports weak-scaling throughput and efficiency.

``--cpu`` uses a virtual CPU mesh (hardware-free, like every sharding
test; its times measure XLA's CPU backend, not devices); on a host with
several GPUs the same command measures scaling over their interconnect:

    python -m clenabled_tpu.tools.test_scaling --devices 1 2 4
"""

from __future__ import annotations

import argparse
import time


def _step_seconds(step, iterations: int) -> float:
    """Seconds per step: step(k) runs k chained steps and returns their
    last outputs; one warm-up step compiles, then a host clock runs
    around ``iterations`` steps ended by block_until_ready."""
    import jax

    jax.block_until_ready(step(1))
    t0 = time.perf_counter()
    jax.block_until_ready(step(iterations))
    return (time.perf_counter() - t0) / iterations


def _setup(args):
    """Apply --cpu (virtual multi-device CPU mesh) and the compile cache;
    returns (jax, the mesh sizes that fit the available devices)."""
    if args.cpu:
        # the flag must be set before jax initializes its backends
        import os

        if "xla_force_host_platform_device_count" not in os.environ.get(
                "XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count="
                f"{max(args.devices)}")
    import jax

    from clenabled_tpu.runtime.config import init_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    init_compile_cache()
    avail = len(jax.devices())
    sizes = [d for d in args.devices if d <= avail]
    if not sizes:
        raise SystemExit(f"no requested mesh size fits {avail} devices")
    return jax, sizes


def main() -> None:
    ap = argparse.ArgumentParser(description="sharded pipeline scaling")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--samples-per-chip", type=int, default=1 << 16)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="force the virtual CPU mesh")
    ap.add_argument("--xengine", action="store_true",
                    help="weak-scale the stacked sharded X-Engine instead "
                    "of the flagship (stations grow with the mesh; int8 "
                    "lanes over the all_to_all)")
    ap.add_argument("--stations-per-chip", type=int, default=8)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--integration", type=int, default=512)
    ap.add_argument("--ospfb", action="store_true",
                    help="weak scaling of the time-sharded oversampled "
                    "PFB (16 channels, R=8; ring-ppermute halo)")
    ap.add_argument("--xcorr", action="store_true",
                    help="weak scaling of the window-parallel sharded TD "
                    "xcorr (windows grow with the mesh; zero collectives)")
    ap.add_argument("--windows-per-chip", type=int, default=8)
    ap.add_argument("--signal-length", type=int, default=8192)
    ap.add_argument("--max-shift", type=int, default=512)
    args = ap.parse_args()

    jax, sizes = _setup(args)
    if args.xengine:
        _xengine_scaling(args, jax, sizes)
        return
    if args.ospfb:
        _ospfb_scaling(args, jax, sizes)
        return
    if args.xcorr:
        _xcorr_scaling(args, jax, sizes)
        return

    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from clenabled_tpu.pipelines import (FxPipelineConfig,
                                         make_sharded_fx_pipeline)

    print(f"platform: {jax.devices()[0].platform} x{len(jax.devices())}   "
          f"samples/device/step: {args.samples_per_chip}")
    base_msps = None
    for d in sizes:
        mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
        cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                               samples_per_step=args.samples_per_chip)
        fn, (xr, xi, hr, hi) = make_sharded_fx_pipeline(mesh, cfg=cfg)
        rng = np.random.default_rng(0)
        shard = NamedSharding(mesh, P(None, "shard"))
        xr = jax.device_put(rng.standard_normal(xr.shape).astype(np.float32),
                            shard)
        xi = jax.device_put(rng.standard_normal(xi.shape).astype(np.float32),
                            shard)

        def step(k):
            h = (hr, hi)
            for _ in range(k):
                out = fn(xr, xi, *h)
                h = out[3:]
            return out

        step_s = _step_seconds(step, args.iterations)
        total_msps = args.samples_per_chip * d / step_s / 1e6
        per_dev = total_msps / d
        if base_msps is None:
            base_msps = per_dev
        eff = per_dev / base_msps * 100.0
        print(f"  {d} device(s): {total_msps:8.2f} MSPS total   "
              f"{per_dev:8.2f} MSPS/device   efficiency {eff:5.1f}%")


def _xengine_scaling(args, jax, sizes) -> None:
    """Weak scaling of make_sharded_xengine_stacked: stations grow with
    the mesh (S = stations_per_chip·D), so per-device Gram work stays
    ~equal while the all_to_all and the baseline count grow — the
    multi-device X-Engine deployment shape."""
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from clenabled_tpu.dsp import xengine as dsp_xengine
    from clenabled_tpu.sharding import make_sharded_xengine_stacked

    p, f, t = 2, args.channels, args.integration
    print(f"platform: {jax.devices()[0].platform} x{len(jax.devices())}   "
          f"stations/device: {args.stations_per_chip}  pols: {p}  "
          f"channels: {f}  integration: {t}  (int8 ingest)")
    base = None
    for d in sizes:
        mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
        s = args.stations_per_chip * d
        init, apply = make_sharded_xengine_stacked(
            s, f, p, t, mesh, scale=1.0 / 127.0 ** 2)
        rng = np.random.default_rng(0)
        zr = jnp.asarray(rng.integers(-127, 128, (f, t, s * p), dtype=np.int8))
        zi = jnp.asarray(rng.integers(-127, 128, (f, t, s * p), dtype=np.int8))

        def step(k):
            st = init()
            for _ in range(k):
                st, (out, ready) = apply(st, (zr, zi))
            return out

        step_s = _step_seconds(step, args.iterations)
        nb = dsp_xengine.num_baselines(s)
        useful = 8.0 * f * t * nb * p * p
        tflops = useful / step_s / 1e12
        per_dev = tflops / d
        if base is None:
            base = per_dev
        print(f"  {d} device(s), S={s}: {tflops:8.3f} TFLOP/s useful   "
              f"{per_dev:8.3f} /device   efficiency "
              f"{per_dev / base * 100:5.1f}%")


def _xcorr_scaling(args, jax, sizes) -> None:
    """Weak scaling of the window-parallel sharded TD xcorr: analysis
    windows grow with the mesh, zero collectives in the hot path —
    efficiency measures pure SPMD overhead."""
    import numpy as np
    from jax.sharding import Mesh

    from clenabled_tpu.sharding import make_sharded_td_xcorr

    ns, L, ms = 2, args.signal_length, args.max_shift
    print(f"platform: {jax.devices()[0].platform} x{len(jax.devices())}   "
          f"TD xcorr windows/device: {args.windows_per_chip}  "
          f"signal: {L}  max_shift: {ms}")
    rng = np.random.default_rng(0)
    base = None
    for d in sizes:
        mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
        apply = make_sharded_td_xcorr(mesh, ms)
        b = args.windows_per_chip * d
        mags = jax.device_put(
            np.abs(rng.standard_normal((ns, b, L))).astype(np.float32))

        def step(k):
            for _ in range(k):
                res = apply(mags)
            return res.corr

        step_s = _step_seconds(step, args.iterations)
        total = b * L / step_s / 1e6
        per_dev = total / d
        if base is None:
            base = per_dev
        print(f"  {d} device(s), B={b}: {total:10.1f} MSPS of windowed "
              f"stream   {per_dev:10.1f} /device   efficiency "
              f"{per_dev / base * 100:5.1f}%")


def _ospfb_scaling(args, jax, sizes) -> None:
    """Weak scaling of the time-sharded oversampled PFB
    (make_sharded_channelizer_planar, 16 channels, R=8): per-device sample
    block fixed (samples grow with D), halo = one ring ppermute per step —
    communication is O(1) per device while compute scales."""
    import numpy as np
    from jax.sharding import Mesh

    from clenabled_tpu.dsp import firdes, planar
    from clenabled_tpu.sharding import make_sharded_channelizer_planar

    m, r = 16, 8
    proto = firdes.low_pass(1.0, float(m), 0.5, 0.25)
    local = max(m, args.samples_per_chip // m * m)
    print(f"platform: {jax.devices()[0].platform} x{len(jax.devices())}   "
          f"OS-PFB 16ch/R=8, samples/device/step: {local}")
    rng = np.random.default_rng(0)
    base = None
    for d in sizes:
        mesh = Mesh(np.array(jax.devices()[:d]), ("shard",))
        init_s, apply_s = make_sharded_channelizer_planar(
            proto, m, r, list(range(m)), mesh)
        n = d * local
        x = planar.PC(
            jax.device_put(rng.standard_normal(n).astype(np.float32)),
            jax.device_put(rng.standard_normal(n).astype(np.float32)))

        def step(k):
            s = init_s()
            for _ in range(k):
                s, o = apply_s(s, x)
            return o.re

        step_s = _step_seconds(step, args.iterations)
        total = n / step_s / 1e6
        per_dev = total / d
        if base is None:
            base = per_dev
        print(f"  {d} device(s): {total:8.1f} MSPS total   "
              f"{per_dev:8.1f} MSPS/device   efficiency "
              f"{per_dev / base * 100:5.1f}%")


if __name__ == "__main__":
    main()
