"""Filter benchmark — the reference's test-clfilter (lib/test-clfilter.cc):
time-domain FIR vs frequency-domain (overlap-add) filter throughput for a
given --ntaps, like the study tables (BASELINE.md rows 1-6)."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="FIR vs FFT filter benchmark")
    ap.add_argument("--ntaps", type=int, default=241)
    ap.add_argument("--blocksize", type=int, default=1 << 18)
    ap.add_argument("--decimation", type=int, default=1)
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

    from clenabled_tpu.dsp import fft_filter, fir_filter, firdes, planar

    # RRC like the 241-tap benchmark variant; any ntaps accepted
    taps = firdes.root_raised_cosine(1.0, 10e6, 10e6 / (args.ntaps / 11 + 2),
                                     0.22, args.ntaps)
    print(f"platform: {T.platform_banner()}   ntaps: {len(taps)}   "
          f"blocksize: {args.blocksize}   decim: {args.decimation}   "
          f"planar: {args.planar}")

    it = args.iterations
    if args.percall:
        tst = lambda fn, st, fr: T.time_stateful(fn, st, fr, iterations=it)
    else:
        tst = lambda fn, st, fr: T.time_stateful_scan(fn, st, fr,
                                                      reps=min(64, it))
    print("timing: " + ("per-call" if args.percall else
                        "scanned device-side chained reps (--percall for "
                        "the reference's per-dispatch style)"))

    if args.planar:
        nn = max(1, args.blocksize // 1024) * 1024
        frame = planar.PC(jax.device_put(T.rand_float(nn, 1)),
                          jax.device_put(T.rand_float(nn, 2)))
        fini, fapp = fir_filter.make_fir_filter_planar_xla(
            taps, args.decimation)
        secs = tst(fapp, fini(), frame)
        T.report("time-domain FIR (planar)", nn, secs)
        oini, oapp, plan = fft_filter.make_fft_filter_planar(
            taps, args.decimation)
        q = fft_filter.frame_quantum(plan)
        n2 = max(1, args.blocksize // q) * q
        frame2 = planar.PC(jax.device_put(T.rand_float(n2, 3)),
                           jax.device_put(T.rand_float(n2, 4)))
        secs = tst(oapp, oini(), frame2)
        T.report(f"freq-domain OFA (fft {plan.fftsize})", n2, secs)
        return

    x = jax.device_put(T.rand_complex(args.blocksize))
    fini, fapp = fir_filter.make_fir_filter(taps, args.decimation)
    secs = tst(fapp, fini(), x)
    T.report("time-domain FIR", args.blocksize, secs)

    oini, oapp, plan = fft_filter.make_fft_filter(taps, args.decimation)
    q = fft_filter.frame_quantum(plan)
    nn = max(1, args.blocksize // q) * q
    x2 = jax.device_put(T.rand_complex(nn))
    secs = tst(oapp, oini(), x2)
    T.report(f"freq-domain OFA (fft {plan.fftsize})", nn, secs)


if __name__ == "__main__":
    main()
