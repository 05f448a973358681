"""FFT benchmark — the reference's test-clenabled-fft
(lib/test-clenabled-fft.cc): FFT-specific timing with shift/window/stream
options (mirrors --fft-shift / --fft-num-streams of test-clenabled)."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="FFT benchmark")
    ap.add_argument("blocksize", nargs="?", type=int, default=1 << 18)
    ap.add_argument("--fft-size", type=int, default=2048)
    ap.add_argument("--fft-shift", action="store_true")
    ap.add_argument("--fft-num-streams", type=int, default=1)
    ap.add_argument("--reverse", action="store_true")
    ap.add_argument("--window", action="store_true",
                    help="apply a Blackman-Harris window")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--planar", action="store_true",
                    help="complex-free planar float32 path")
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--percall", action="store_true",
                    help="per-dispatch timing (the reference's style); "
                         "default: device-side chained reps (lax.scan)")
    args = ap.parse_args()

    from clenabled_tpu.tools import _timing as T
    T.select_platform(args)

    import jax

    from clenabled_tpu.dsp import fft as dsp_fft
    from clenabled_tpu.dsp import window as win

    size = args.fft_size
    n = (args.blocksize // size) * size
    streams = args.fft_num_streams
    direction = dsp_fft.REVERSE if args.reverse else dsp_fft.FORWARD
    w = win.blackman_harris(size) if args.window else None
    print(f"platform: {T.platform_banner()}   fft_size: {size}  "
          f"block: {n}  streams: {streams}  shift: {args.fft_shift}  "
          f"window: {args.window}  dir: {'rev' if args.reverse else 'fwd'}")

    if args.planar:
        from clenabled_tpu.dsp import planar as pl_mod

        xs = []
        for i in range(streams):
            xs.append(jax.device_put(T.rand_float(n, i)))
            xs.append(jax.device_put(T.rand_float(n, 100 + i)))

        fn = jax.jit(lambda *ss: tuple(
            dsp_fft.fft_stream_planar(
                pl_mod.PC(ss[2 * i], ss[2 * i + 1]), size,
                direction=direction, window=w, shift=args.fft_shift)
            for i in range(streams)))
    else:
        xs = [jax.device_put(T.rand_complex(n, i)) for i in range(streams)]

        fn = jax.jit(lambda *ss: tuple(
            dsp_fft.fft_stream(x, size, direction=direction, window=w,
                               shift=args.fft_shift) for x in ss))
    if args.percall:
        secs = T.time_fn(fn, *xs, iterations=args.iterations)
    else:
        secs = T.time_fn_scan(fn, *xs, reps=min(64, args.iterations))
    T.report(f"fft {size}", n * streams, secs,
             extra=f"{n * streams // size} transforms/call")


if __name__ == "__main__":
    main()
