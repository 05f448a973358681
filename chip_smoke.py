"""On-card smoke test of the system's main path on NVIDIA GPUs.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # the paths that exist across 4 cards

One card: the flagship FX pipeline (4 antennas, 16-channel critically
sampled PFB with the default 400-tap prototype, FD cross-correlation
against antenna 0, X-Engine over the channelized spectra, 2^23 samples per
antenna per step) in both XLA forms against the float64 NumPy reference
under the default and the "highest" matmul precision; the block API
(SignalSource → Fft → ComplexToMag) against np.fft; the int8 X-Engine at
S=64, P=2, F=256, T=8192 integer-exact against NumPy; whether the native
host library built.  Four cards: the time-sharded flagship and the
station→channel sharded X-Engine, each against the one-card form.

Exits non-zero on any failure and then prints no result.  JAX must find a
GPU: there is no CPU fallback.  The last line of standard output is one
JSON object, {"ok": true, "device": {"platform", "kind", "count"}}.
Timings are host clocks around work ended by jax.block_until_ready.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 1234

# Flagship deployment (bench.py's): 4 antennas, 16 channels, 2^23 samples.
A, M, N = 4, 16, 1 << 23
STEPS_CHECKED = 2       # carried steps compared with the reference
STEPS_TIMED = 20

# Normwise relative tolerances of the flagship against the float64
# reference, by matmul precision.  "default": on a GPU XLA may run float32
# dots (the planar DFTs, the X-Engine Gram) in TF32, whose operands keep
# 10 mantissa bits (unit roundoff 2^-11 ≈ 4.9e-4); products of rounded
# operands err by ~1e-3 each, random in sign, so 1e-2 gives a 10× margin.
# "highest": true float32 products; the Gram and the frame mean accumulate
# T = 2^19 terms per step, a random-walk error of ~sqrt(T)·2^-24 ≈ 4e-5,
# so 1e-4 leaves a ~2× margin.
TOL = {"default": 1e-2, "highest": 1e-4}
# Four cards against one card, same precision and the same per-element
# arithmetic: only the order of the float32 sums over time differs
# (shards' partial sums, then a psum) — a few ×sqrt(T)·2^-24.
TOL_SHARDED = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _precision(name: str):
    import jax

    if name == "default":
        return contextlib.nullcontext()
    return jax.default_matmul_precision(name)


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: not available"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(ma, f, 0) / 2**20:.1f} MiB"
        for f in fields)


def phase_environment(cards: int):
    import jax

    from clenabled_tpu.runtime.config import init_compile_cache

    cache = init_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(
            f"JAX found no GPU (devices: {devs}); chip_smoke.py runs on "
            f"NVIDIA GPUs only")
    check(len(devs) >= cards, f"need {cards} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines()[:cards]:
        log(line.strip())
    log(f"jax {jax.__version__}  devices: {devs[:cards]}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache: {cache} ({n_cached} entries at start)")
    return devs[:cards]


def _flagship_inputs(rng, n):
    return [(rng.standard_normal((A, n), dtype=np.float32),
             rng.standard_normal((A, n), dtype=np.float32))
            for _ in range(STEPS_CHECKED)]


def _reference_steps(inputs, taps):
    from clenabled_tpu import reference

    hist = np.zeros((A, len(taps) - 1), np.complex128)
    out = []
    for xr, xi in inputs:
        fd, xm, hist = reference.flagship_step(xr + 1j * xi.astype(np.float64),
                                               hist, taps, M)
        out.append((fd, xm))
    return out


def _form(name, cfg):
    """(fn, example_args, to_args(xr, xi) → device args, n_state,
    xmat(out) → complex X-Engine matrix) for one flagship form."""
    import jax
    import jax.numpy as jnp

    from clenabled_tpu.pipelines import (make_fx_pipeline,
                                         make_fx_pipeline_planar)

    if name == "planar":
        fn, args = make_fx_pipeline_planar(cfg)
        return (fn, args,
                lambda xr, xi: (jax.device_put(xr), jax.device_put(xi)), 2,
                lambda out: np.asarray(out[1]) + 1j * np.asarray(out[2]))
    fn, args = make_fx_pipeline(cfg)
    return (fn, args,
            lambda xr, xi: (jax.device_put(xr) + 1j * jax.device_put(xi)
                            .astype(jnp.complex64),),
            1, lambda out: np.asarray(out[1]))


def phase_flagship():
    import jax

    from clenabled_tpu import reference
    from clenabled_tpu.pipelines import FxPipelineConfig, flagship_taps

    cfg = FxPipelineConfig(num_antennas=A, num_channels=M,
                           samples_per_step=N)
    taps = flagship_taps(M)
    log(f"== flagship: {A} antennas, {M} channels, {len(taps)}-tap "
        f"prototype, {N} samples/antenna/step "
        f"({A * N * 8 / 1e6:.0f} MB float32 planar input per step)")
    rng = np.random.default_rng(SEED)
    inputs = _flagship_inputs(rng, N)
    ref, t_ref = _timed(lambda: _reference_steps(inputs, taps))
    log(f"float64 reference: {STEPS_CHECKED} steps in {t_ref:.1f} s")

    for form in ("planar", "complex"):
        fn, args0, to_args, n_state, xmat = _form(form, cfg)
        for prec in ("default", "highest"):
            with _precision(prec):
                lowered = fn.lower(*args0)
                compiled, t_c = _timed(lowered.compile)
            log(f"[{form}/{prec}] compile {t_c:.2f} s; "
                f"{_memory_line(compiled)}")
            if prec == "default":
                jax.clear_caches()
                with _precision(prec):
                    _, t_w = _timed(fn.lower(*args0).compile)
                log(f"[{form}/{prec}] compile after clearing the in-memory "
                    f"caches (persistent cache warm): {t_w:.2f} s")
            state = args0[len(args0) - n_state:]
            for k, (xr, xi) in enumerate(inputs):
                out = compiled(*to_args(xr, xi), *state)
                state = out[len(out) - n_state:]
                e_fd = reference.normwise_rel_err(out[0], ref[k][0])
                e_xm = reference.normwise_rel_err(xmat(out), ref[k][1])
                log(f"[{form}/{prec}] step {k}: fd rel err {e_fd:.3e}, "
                    f"xmat rel err {e_xm:.3e} (tolerance {TOL[prec]:.0e})")
                check(out[0].shape == (A - 1, M), f"fd shape {out[0].shape}")
                check(np.isfinite(np.asarray(out[0])).all(), "fd not finite")
                check(e_fd < TOL[prec] and e_xm < TOL[prec],
                      f"{form}/{prec} step {k} exceeds tolerance")
            if prec == "default":
                dev = to_args(*inputs[0])
                jax.block_until_ready(compiled(*dev, *state))
                t0 = time.perf_counter()
                for _ in range(STEPS_TIMED):
                    out = compiled(*dev, *state)
                    state = out[len(out) - n_state:]
                jax.block_until_ready(out)
                per = (time.perf_counter() - t0) / STEPS_TIMED
                log(f"[{form}/{prec}] step time {per * 1e3:.3f} ms over "
                    f"{STEPS_TIMED} carried steps = {N / per / 1e6:.1f} "
                    f"MSPS per antenna")
            del compiled
    xr, xi = inputs[0]
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready((jax.device_put(xr), jax.device_put(xi)))
        ts.append(time.perf_counter() - t0)
    t_put = statistics.median(ts)
    log(f"host->device copy of one step's input ({2 * xr.nbytes / 1e6:.0f} "
        f"MB, pageable NumPy): {t_put * 1e3:.2f} ms = "
        f"{2 * xr.nbytes / t_put / 1e9:.2f} GB/s (median of 3)")


def phase_block_api():
    import jax

    from clenabled_tpu import blocks
    from clenabled_tpu.streaming import Flowgraph

    log("== block API: SignalSource(1 MHz, 150 kHz tone, 8192/frame) -> "
        "Fft(2048, shift) -> ComplexToMag")
    g = Flowgraph()
    src = blocks.SignalSource(1e6, 1, 150e3, 1.0, 8192)
    fft = blocks.Fft(2048, shift=True)
    mag = blocks.ComplexToMag()
    g.connect(src, fft)
    g.connect(fft, mag)
    tap_src, tap_mag = g.tap(src), g.tap(mag)
    runner = g.compile()
    for k in range(3):
        out = runner.step()
        x = np.asarray(out[tap_src], np.complex128).reshape(-1, 2048)
        got = np.asarray(out[tap_mag]).reshape(-1, 2048)
        want = np.abs(np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1))
        err = float(np.abs(got - want).max() / np.abs(want).max())
        peak = int(np.argmax(got.mean(axis=0)))
        log(f"step {k}: {got.shape} max rel err vs np.fft {err:.2e}; "
            f"peak bin {peak} (expected {1024 + round(150e3 / 1e6 * 2048)})")
        check(err < 1e-4, "block API output differs from np.fft")
        check(peak == 1024 + round(150e3 / 1e6 * 2048), "tone in wrong bin")
    jax.block_until_ready(runner.states)


def _int8_operands(rng, f, t, sp):
    return (rng.integers(-127, 128, (f, t, sp), dtype=np.int8),
            rng.integers(-127, 128, (f, t, sp), dtype=np.int8))


def _gram_exact(zr, zi):
    """NumPy int64 Gram (gr = rr + ii, gi = ir − ri) of int8 operands,
    accumulated by float64 BLAS: every product is ≤ 127² and every partial
    sum below 2·T·127² < 2^53, so the float64 sums are exact integers."""
    w = np.concatenate([zr, zi], axis=-1).astype(np.float64)
    g2 = np.matmul(np.swapaxes(w, 1, 2), w)               # [F, 2SP, 2SP]
    sp = zr.shape[-1]
    g2 = np.rint(g2).astype(np.int64)
    return (g2[:, :sp, :sp] + g2[:, sp:, sp:],
            g2[:, sp:, :sp] - g2[:, :sp, sp:])


def phase_xengine_int8():
    import jax

    from clenabled_tpu.dsp import xengine

    s, p, f, t = 64, 2, 256, 8192
    sp = s * p
    log(f"== int8 X-Engine: S={s} P={p} F={f} T={t} "
        f"({2 * f * t * sp / 1e6:.0f} MB of int8 operands)")
    rng = np.random.default_rng(SEED + 1)
    zr, zi = _int8_operands(rng, f, t, sp)
    want_r, want_i = _gram_exact(zr, zi)
    zr_d, zi_d = jax.device_put(zr), jax.device_put(zi)
    gram = jax.jit(xengine.xengine_gram_stacked)
    compiled, t_c = _timed(lambda: gram.lower(zr_d, zi_d).compile())
    log(f"compile {t_c:.2f} s; {_memory_line(compiled)}")
    gr, gi = compiled(zr_d, zi_d)
    check(gr.dtype == np.int32, f"Gram dtype {gr.dtype}")
    exact = (np.array_equal(np.asarray(gr, np.int64), want_r)
             and np.array_equal(np.asarray(gi, np.int64), want_i))
    log(f"int32 Gram equals the NumPy int64 Gram: {exact}")
    check(exact, "int8 X-Engine Gram is not integer-exact")
    iters = 20
    jax.block_until_ready(compiled(zr_d, zi_d))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = compiled(zr_d, zi_d)
    jax.block_until_ready(out)
    per = (time.perf_counter() - t0) / iters
    ops = 2.0 * f * t * (2 * sp) ** 2      # executed by the stacked matmul
    log(f"stacked int8 Gram: {per * 1e3:.3f} ms/call, "
        f"{ops / per / 1e12:.1f} TOP/s executed int8 ops = "
        f"{ops / per / 1.979e15 * 100:.1f}% of the 1,979 TOP/s dense int8 "
        f"peak (H100 SXM data sheet)")
    tri = jax.jit(lambda a, b: xengine.xengine_correlate_stacked(a, b, npol=p))
    jax.block_until_ready(tri(zr_d, zi_d))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = tri(zr_d, zi_d)
    jax.block_until_ready(out)
    log(f"xengine_correlate_stacked (Gram + triangular order): "
        f"{(time.perf_counter() - t0) / iters * 1e3:.3f} ms/call")


def phase_native():
    from clenabled_tpu import native

    lib = native.get_lib()
    log(f"native host library: {'built at ' + native.lib_path() if lib else 'NOT built: ' + str(native.build_error())}")


def phase_sharded_flagship(devs):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from clenabled_tpu import reference
    from clenabled_tpu.pipelines import (FxPipelineConfig,
                                         make_fx_pipeline_planar,
                                         make_sharded_fx_pipeline)

    d = len(devs)
    mesh = Mesh(np.array(devs), ("shard",))
    cfg = FxPipelineConfig(num_antennas=A, num_channels=M, samples_per_step=N)
    log(f"== sharded flagship: {d} cards x {N} samples/antenna/step, ring "
        f"ppermute halo, psum integration, vs one card on the {d * N}-"
        f"sample stream")
    fn_s, (_, _, hr_s, hi_s) = make_sharded_fx_pipeline(mesh, cfg=cfg)
    fn_1, (_, _, hr_1, hi_1) = make_fx_pipeline_planar(
        cfg._replace(samples_per_step=d * N))
    shard = NamedSharding(mesh, P(None, "shard"))
    # the history comes back replicated over the mesh: start it so too, so
    # the second step reuses the first step's executable
    hr_s, hi_s = jax.device_put((hr_s, hi_s), NamedSharding(mesh, P()))
    rng = np.random.default_rng(SEED + 2)
    inputs = _flagship_inputs(rng, d * N)
    for k, (xr, xi) in enumerate(inputs):
        dev = (jax.device_put(xr, shard), jax.device_put(xi, shard))
        got, t_s = _timed(lambda: jax.block_until_ready(
            fn_s(*dev, hr_s, hi_s)))
        log(f"step {k}: sharded step {t_s:.2f} s"
            + (" (first call: compile + run)" if k == 0 else ""))
        want = fn_1(jax.device_put(xr, devs[0]), jax.device_put(xi, devs[0]),
                    hr_1, hi_1)
        hr_s, hi_s = got[3:]
        hr_1, hi_1 = want[3:]
        errs = [reference.normwise_rel_err(g, w) for g, w in zip(got, want)]
        log(f"step {k}: rel err vs one card fd {errs[0]:.2e} xre "
            f"{errs[1]:.2e} xim {errs[2]:.2e} hist {errs[3]:.2e} "
            f"(tolerance {TOL_SHARDED:.0e})")
        check(max(errs) < TOL_SHARDED, "sharded flagship differs from one card")
    t0 = time.perf_counter()
    for _ in range(STEPS_TIMED):
        out = fn_s(*dev, hr_s, hi_s)
        hr_s, hi_s = out[3:]
    jax.block_until_ready(out)
    per = (time.perf_counter() - t0) / STEPS_TIMED
    log(f"sharded step time {per * 1e3:.3f} ms = {d * N / per / 1e6:.1f} "
        f"MSPS per antenna over {d} cards")


def phase_sharded_xengine(devs):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from clenabled_tpu.dsp import xengine
    from clenabled_tpu.sharding import make_sharded_xengine_stacked

    d = len(devs)
    s, p, f, t = 64, 2, 256, 8192
    mesh = Mesh(np.array(devs), ("shard",))
    log(f"== sharded int8 X-Engine: S={s} P={p} F={f} T={t}, "
        f"station-sharded over {d} cards, all_to_all to channels")
    rng = np.random.default_rng(SEED + 3)
    zr, zi = _int8_operands(rng, f, t, s * p)
    init, apply = make_sharded_xengine_stacked(s, f, p, t, mesh)
    lane = NamedSharding(mesh, P(None, None, "shard"))
    _, (out, ready) = apply(init(), (jax.device_put(zr, lane),
                                     jax.device_put(zi, lane)))
    one = jax.jit(lambda a, b: xengine.xengine_correlate_stacked(a, b,
                                                                 npol=p))
    want = one(jax.device_put(zr, devs[0]), jax.device_put(zi, devs[0]))
    same = (bool(np.asarray(ready))
            and np.array_equal(np.asarray(out.re), np.asarray(want.re))
            and np.array_equal(np.asarray(out.im), np.asarray(want.im)))
    log(f"sharded triangular output {out.re.shape} equals one card's: {same}")
    check(same, "sharded X-Engine differs from one card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    try:
        import clenabled_tpu
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the package: {e}",
              file=sys.stderr)
        return 1
    if Path(clenabled_tpu.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: FAIL: clenabled_tpu comes from "
              f"{clenabled_tpu.__file__}, not from this checkout",
              file=sys.stderr)
        return 1
    try:
        devs = phase_environment(args.cards)
        if args.cards == 1:
            phase_flagship()
            phase_block_api()
            phase_xengine_int8()
            phase_native()
        else:
            phase_sharded_flagship(devs)
            phase_sharded_xengine(devs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
