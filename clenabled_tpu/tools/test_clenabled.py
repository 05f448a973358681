"""Block-by-block throughput benchmark — the reference's test-clenabled
(lib/test_clenabled.cc): iterations-averaged samples/s for every block
class.  --cpu selects the hardware-free JAX CPU backend (the role of
OpenCL-on-CPU); positional blocksize mirrors the reference CLI.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="block throughput benchmark")
    ap.add_argument("blocksize", nargs="?", type=int, default=8192)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--percall", action="store_true",
                    help="time one device dispatch per call (the "
                         "reference's original timing style); default is "
                         "device-side chained reps (lax.scan), the number "
                         "a Runner at the compile() default sustains")
    ap.add_argument("--testcostas", action="store_true",
                    help="include the (sequential) Costas loop")
    ap.add_argument("--planar", action="store_true",
                    help="complex-free planar float32 path")
    ap.add_argument("--baseline-only", action="store_true",
                    help="only the no-op copy baseline")
    args = ap.parse_args()

    from clenabled_tpu.tools import _timing as T
    T.select_platform(args)

    import jax
    import jax.numpy as jnp

    from clenabled_tpu.dsp import (demod, elementwise as ew, fft as dsp_fft,
                                   fft_filter, fir_filter, firdes, siggen,
                                   window as win)

    n = args.blocksize
    it = args.iterations
    if args.percall:
        tfn = lambda f, *a: T.time_fn(f, *a, iterations=it)
        tst = lambda f, s, *a: T.time_stateful(f, s, *a, iterations=it)
        mode = "per-call"
    else:
        reps = min(64, it)
        tfn = lambda f, *a: T.time_fn_scan(f, *a, reps=reps)
        tst = lambda f, s, *a: T.time_stateful_scan(f, s, *a, reps=reps)
        mode = "scanned (device-side chained reps; --percall for the " \
               "reference's per-dispatch style)"
    print(f"platform: {T.platform_banner()}   blocksize: {n}   "
          f"iterations: {it}   timing: {mode}")

    if args.planar:
        from clenabled_tpu.dsp import planar as pl_mod

        ar = jax.device_put(T.rand_float(n, 1))
        ai = jax.device_put(T.rand_float(n, 11))
        br = jax.device_put(T.rand_float(n, 2))
        bi = jax.device_put(T.rand_float(n, 12))
        f = jax.device_put(T.rand_float(n, 3) ** 2 + 0.1)
        g = jax.device_put(T.rand_float(n, 4) ** 2 + 0.1)
        T.report("empty w/copy (baseline)", n, tfn(jax.jit(lambda x: x + 0), ar))
        if args.baseline_only:
            return
        PC = pl_mod.PC
        T.report("multiply (cc planar)", n, tfn(jax.jit(lambda r, i, r2, i2: pl_mod.mul(PC(r, i), PC(r2, i2))),
            ar, ai, br, bi))
        T.report("multiply conjugate", n, tfn(jax.jit(lambda r, i, r2, i2: pl_mod.mul_conj(PC(r, i), PC(r2, i2))),
            ar, ai, br, bi))
        T.report("complex->mag", n, tfn(jax.jit(lambda r, i: pl_mod.pabs(PC(r, i))), ar, ai))
        T.report("complex->arg", n, tfn(jax.jit(lambda r, i: jnp.arctan2(i, r)), ar, ai))
        T.report("log10 (n,k)", n, tfn(jax.jit(lambda x: ew.log10(x, 10.0, 1.0)), f))
        T.report("snr helper", n, tfn(jax.jit(lambda x, y: ew.snr_helper(x, y, 10.0)), f, g))
        from clenabled_tpu.dsp import fft as dsp_fft_mod
        w2 = win.blackman_harris(2048)
        T.report("fft 2048 fwd+win+shift", n, tfn(jax.jit(lambda r, i: dsp_fft_mod.fft_stream_planar(
                PC(r, i), 2048, window=w2, shift=True)),
            ar, ai))
        qdp = jax.jit(lambda r, i: demod.quadrature_demod_planar(PC(r, i), 1.0))
        T.report("quadrature demod", n, tfn(qdp, ar, ai))
        if args.testcostas:
            # the exact loop is one sequential step per sample: bound the
            # frame so the chained-reps device program stays seconds
            nc = min(n, 1 << 16)
            cr, ci = ar[:nc], ai[:nc]
            run = demod.make_costas_loop_planar(0.02, 2)
            T.report(f"costas loop (order 2, n={nc})", nc,
                     tst(lambda st, r, i: run(st, PC(r, i)),
                         demod.costas_init(), cr, ci))
        return

    a = jax.device_put(T.rand_complex(n, 1))
    b = jax.device_put(T.rand_complex(n, 2))
    f = jax.device_put(T.rand_float(n, 3) ** 2 + 0.1)
    g = jax.device_put(T.rand_float(n, 4) ** 2 + 0.1)

    copy = jax.jit(lambda x: x + 0)
    T.report("empty w/copy (baseline)", n, tfn(copy, a))
    if args.baseline_only:
        return

    mult = jax.jit(lambda x, y: ew.math_op(ew.MATHOP_MULTIPLY, x, y))
    T.report("multiply (cc)", n, tfn(mult, a, b))
    T.report("add (cc)", n, tfn(jax.jit(lambda x, y: x + y), a, b))
    T.report("multiply conjugate", n, tfn(jax.jit(ew.multiply_conjugate), a, b))
    T.report("complex conjugate", n, tfn(jax.jit(ew.complex_conjugate), a))
    T.report("multiply const", n, tfn(jax.jit(lambda x: ew.multiply_const(x, 2.0)), a))
    T.report("complex->mag", n, tfn(jax.jit(ew.complex_to_mag), a))
    T.report("complex->arg", n, tfn(jax.jit(ew.complex_to_arg), a))
    T.report("complex->magphase", n, tfn(jax.jit(ew.complex_to_mag_phase), a))
    T.report("magphase->complex", n, tfn(jax.jit(ew.mag_phase_to_complex), f, g))
    T.report("log10 (n,k)", n, tfn(jax.jit(lambda x: ew.log10(x, 10.0, 1.0)), f))
    T.report("snr helper", n, tfn(jax.jit(lambda x, y: ew.snr_helper(x, y, 10.0)), f, g))

    # signal source
    init, gen = siggen.make_signal_source(10e6, 1, 1e6, 1.0, n)
    st = init()
    T.report("signal source", n, tst(lambda s, _: gen(s), st, 0))

    # quadrature demod
    qd = jax.jit(lambda x: demod.quadrature_demod(x, 1.0))
    T.report("quadrature demod", n, tfn(qd, a))

    # FFT 2048 w/ window
    w = win.blackman_harris(2048)
    fftf = jax.jit(lambda x: dsp_fft.fft_stream(x, 2048, window=w, shift=True))
    T.report("fft 2048 fwd+win+shift", n, tfn(fftf, a))

    # filters
    taps = firdes.low_pass(1.0, 10e6, 1e6, 500e3)
    fini, fapp = fir_filter.make_fir_filter(taps)
    T.report(f"FIR filter ({len(taps)} taps)", n, tst(fapp, fini(), a))
    oini, oapp, plan = fft_filter.make_fft_filter(taps)
    q = fft_filter.frame_quantum(plan)
    nn = (n // q) * q or q
    a2 = jax.device_put(T.rand_complex(nn, 5))
    T.report(f"FFT filter ({len(taps)} taps)", nn, tst(oapp, oini(), a2))

    # short-dtype FIR variants (reference fir_filter_scc/fsf,
    # lib/fir_filter.h:160,192)
    import numpy as np

    ctaps = (taps + 1j * taps[::-1]).astype(np.complex64)
    sini, sapp = fir_filter.make_fir_filter_typed(
        ctaps, in_dtype=jnp.int16)
    xs = jax.device_put(
        np.random.default_rng(6).integers(-2000, 2000, n, dtype=np.int16))
    T.report(f"FIR scc ({len(taps)} taps, short in)", n, tst(sapp, sini(), xs))
    fsini, fsapp = fir_filter.make_fir_filter_typed(
        taps, in_dtype=jnp.float32, out_dtype=jnp.int16)
    T.report(f"FIR fsf ({len(taps)} taps, short out)", n, tst(fsapp, fsini(), f))

    if args.testcostas:
        run = demod.make_costas_loop(0.02, 2)
        T.report("costas loop (order 2)", n, tst(run, demod.costas_init(), a))


if __name__ == "__main__":
    main()
