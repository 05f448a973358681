"""Profiling harness — the tracing aux subsystem (SURVEY §5: the reference
has only std::chrono benchmark loops and debug prints; here: real device
traces).  Captures a jax profiler trace of the flagship pipeline for
perfetto/tensorboard.

    python -m clenabled_tpu.tools.profile --outdir chiprun_out/trace --steps 5
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="trace the flagship pipeline")
    ap.add_argument("--outdir", default="chiprun_out/trace")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--samples-per-step", type=int, default=1 << 21)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--pipeline", choices=["planar", "complex"],
                    default="planar")
    args = ap.parse_args()

    import jax
    import numpy as np

    from clenabled_tpu.pipelines import (FxPipelineConfig, make_fx_pipeline,
                                         make_fx_pipeline_planar)
    from clenabled_tpu.runtime.config import init_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    init_compile_cache()

    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=args.samples_per_step)
    rng = np.random.default_rng(0)
    if args.pipeline == "planar":
        fn, (xr, xi, hr, hi) = make_fx_pipeline_planar(cfg)
        x = (jax.device_put(rng.standard_normal(xr.shape).astype(np.float32)),
             jax.device_put(rng.standard_normal(xi.shape).astype(np.float32)))
        state = (hr, hi)
    else:
        fn, (x0, hist) = make_fx_pipeline(cfg)
        x = (jax.device_put((rng.standard_normal(x0.shape)
                             + 1j * rng.standard_normal(x0.shape))
                            .astype(np.complex64)),)
        state = (hist,)
    nstate = len(state)
    out = fn(*x, *state)
    jax.block_until_ready(out)

    with jax.profiler.trace(args.outdir):
        for _ in range(args.steps):
            out = fn(*x, *out[len(out) - nstate:])
        jax.block_until_ready(out)
    print(f"trace written to {args.outdir} "
          f"(open with tensorboard or perfetto)")


if __name__ == "__main__":
    main()
