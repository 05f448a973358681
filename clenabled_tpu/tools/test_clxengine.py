"""X-Engine benchmark — the reference's test-clxengine
(lib/test-clxengine.cc): total & per-station complex samples/s and input
bps "comparable to xGPU" (:297-300); defaults 256 channels, 10000
integration frames (:67-68)."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="X-Engine benchmark")
    ap.add_argument("channels", nargs="?", type=int, default=256)
    ap.add_argument("--num_inputs", type=int, default=16)
    ap.add_argument("--integration-time", dest="integration", type=int,
                    default=1024)
    ap.add_argument("--single-polarization", dest="single_pol",
                    action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--planar", action="store_true",
                    help="complex-free planar float32 path")
    ap.add_argument("--channel-major", dest="channel_major",
                    action="store_true",
                    help="channel-major [F, T, S·P] marshal (no transposes)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 Gram operands, f32 accumulate (exact for "
                    "<=8-bit quantized streams)")
    ap.add_argument("--stacked", action="store_true",
                    help="single-matmul stacked Gram (channel-major; "
                    "operands are read once)")
    ap.add_argument("--int8", action="store_true",
                    help="raw IChar int8 operands on the s8×s8→s32 matmul "
                    "(exact integer accumulation; implies --stacked)")
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--percall", action="store_true",
                    help="per-dispatch timing (the reference's style); "
                         "default: device-side chained reps (lax.scan)")
    args = ap.parse_args()

    from clenabled_tpu.tools import _timing as T
    T.select_platform(args)


    import jax
    import numpy as np

    from clenabled_tpu.dsp import xengine

    s = args.num_inputs
    f = args.channels
    p = 1 if args.single_pol else 2
    t = args.integration
    it = args.iterations
    nb = xengine.num_baselines(s)
    timer = (T.time_fn if args.percall
             else (lambda fn, *a, iterations: T.time_fn_scan(
                 fn, *a, reps=min(32, iterations))))
    print(f"platform: {T.platform_banner()}   stations: {s}  pols: {p}  "
          f"channels: {f}  integration: {t}  baselines: {nb}")

    rng = np.random.default_rng(0)
    if args.stacked or args.int8:
        import jax.numpy as jnp

        q = rng.integers(-127, 128, (2, f, t, s * p))
        if args.int8:
            zr = jax.device_put(q[0].astype(np.int8))
            zi = jax.device_put(q[1].astype(np.int8))
            scale = 1.0 / (127.0 * 127.0)
        else:
            dt = jnp.bfloat16 if args.bf16 else np.float32
            zr = jax.device_put(q[0].astype(dt))
            zi = jax.device_put(q[1].astype(dt))
            scale = 1.0
        fn = jax.jit(lambda r, i2: xengine.xengine_correlate_stacked(
            r, i2, npol=p, scale=scale))
        secs = timer(fn, zr, zi, iterations=it)
    elif args.channel_major:
        import jax.numpy as jnp

        dt = jnp.bfloat16 if args.bf16 else np.float32
        zr = jax.device_put(
            rng.integers(-127, 128, (f, t, s * p)).astype(dt))
        zi = jax.device_put(
            rng.integers(-127, 128, (f, t, s * p)).astype(dt))
        fn = jax.jit(lambda r, i2: xengine.xengine_correlate_channel_major(
            r, i2, npol=p,
            compute_dtype=jnp.bfloat16 if args.bf16 else None))
        secs = timer(fn, zr, zi, iterations=it)
    elif args.planar:
        from clenabled_tpu.dsp import planar

        zr = jax.device_put(rng.standard_normal((t, s, f, p)).astype(np.float32))
        zi = jax.device_put(rng.standard_normal((t, s, f, p)).astype(np.float32))
        fn = jax.jit(lambda r, i2: xengine.xengine_correlate_planar(
            planar.PC(r, i2), npol=p))
        secs = timer(fn, zr, zi, iterations=it)
    else:
        z = jax.device_put(
            (rng.standard_normal((t, s, f, p))
             + 1j * rng.standard_normal((t, s, f, p))).astype(np.complex64))
        fn = jax.jit(lambda x: xengine.xengine_correlate(x, npol=p))
        secs = timer(fn, z, iterations=it)

    samples = t * f  # per-station complex samples per integration
    total = samples * s
    per_station_sps = samples / secs
    total_sps = total / secs
    in_bps = total * 8 * 8 / secs  # complex64 input bits/s
    print(f"total: {total_sps/1e6:.1f} Msps   per-station: "
          f"{per_station_sps/1e6:.2f} Msps   input: {in_bps/1e9:.1f} Gbps")
    flops = 8.0 * t * f * nb * p * p  # cxmac = 8 real ops
    print(f"correlator compute: {flops / secs / 1e12:.2f} TFLOP/s")


if __name__ == "__main__":
    main()
