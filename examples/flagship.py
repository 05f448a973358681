"""The flagship pipeline — 4-antenna PFB channelizer + FD cross-correlator
+ X-Engine in one jitted step.  Demonstrates baseline detection: a common
sky signal on antennas 0 and 2 must light up the ant2–ant0 baseline.

Run:
    python examples/flagship.py [--log2-samples 21]
"""

import argparse
import time

import jax
import numpy as np

from clenabled_tpu.pipelines import FxPipelineConfig, make_fx_pipeline_planar
from clenabled_tpu.runtime.config import init_compile_cache


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log2-samples", type=int, default=21,
                    help="log2 samples per antenna per step")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    init_compile_cache()

    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << args.log2_samples)
    fn, (xr, xi, hr, hi) = make_fx_pipeline_planar(cfg)
    n = cfg.samples_per_step

    # common sky signal on antennas 0 and 2, noise elsewhere
    rng = np.random.default_rng(0)
    sky_r = rng.standard_normal(n).astype(np.float32)
    sky_i = rng.standard_normal(n).astype(np.float32)
    xr_np = 0.3 * rng.standard_normal((4, n)).astype(np.float32)
    xi_np = 0.3 * rng.standard_normal((4, n)).astype(np.float32)
    for ant in (0, 2):
        xr_np[ant] += sky_r
        xi_np[ant] += sky_i
    xr = jax.device_put(xr_np)
    xi = jax.device_put(xi_np)

    jax.block_until_ready(fn(xr, xi, hr, hi))       # compile
    start = time.perf_counter()
    for _ in range(args.steps):
        fd, xre, xim, hr, hi = fn(xr, xi, hr, hi)
    jax.block_until_ready((fd, xre, xim, hr, hi))
    elapsed = time.perf_counter() - start

    from clenabled_tpu.dsp import xengine

    power = np.abs(np.asarray(xre) + 1j * np.asarray(xim)).mean(axis=(0, 2))
    st = xengine.baseline_stations(4)
    cross = [k for k in range(len(st)) if st[k][0] != st[k][1]]
    best = cross[int(np.argmax(power[cross]))]
    print(f"X-Engine strongest cross baseline: ant{st[best][0]}–ant{st[best][1]} "
          f"(expected ant2–ant0)")
    d = jax.devices()[0]
    print(f"pipeline: {n * args.steps / elapsed / 1e6:.1f} MSPS per antenna "
          f"on {d.platform}:{d.device_kind}")


if __name__ == "__main__":
    main()
