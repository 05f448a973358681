"""Benchmark: flagship 4-antenna FD-xcorr + channelizer pipeline throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

value = sustained per-antenna input sample rate (MSPS) of the full pipeline
(16-ch PFB channelizer ×4 antennas + FD cross-correlators + X-Engine
integration) on one device, with the input already on the device.
vs_baseline is measured against the north-star target of 100 MSPS per
device (BASELINE.json; the reference's best comparable number is 46 MSPS
for the async TD correlator chain on a GTX-class GPU, README.md:106).

Measurement: a host clock around 20 carried steps (each step's channelizer
history feeds the next) ended by jax.block_until_ready, after a warm-up
step that compiles.
"""

from __future__ import annotations

import json
import time

import jax
import numpy as np

NORTH_STAR_MSPS = 100.0
STEPS = 20


def main() -> None:
    from clenabled_tpu.pipelines import (FxPipelineConfig,
                                         make_fx_pipeline_planar)
    from clenabled_tpu.runtime.config import init_compile_cache

    init_compile_cache()
    cfg = FxPipelineConfig(num_antennas=4, num_channels=16,
                           samples_per_step=1 << 23)
    fn, (xr, xi, hr, hi) = make_fx_pipeline_planar(cfg)

    rng = np.random.default_rng(0)
    xr = jax.device_put(rng.standard_normal(xr.shape).astype(np.float32))
    xi = jax.device_put(rng.standard_normal(xi.shape).astype(np.float32))

    jax.block_until_ready(fn(xr, xi, hr, hi))        # compile
    t0 = time.perf_counter()
    for _ in range(STEPS):
        fd, xre, xim, hr, hi = fn(xr, xi, hr, hi)
    jax.block_until_ready((fd, xre, xim, hr, hi))
    per_step = (time.perf_counter() - t0) / STEPS

    msps = cfg.samples_per_step / per_step / 1e6    # per-antenna samples/s
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "fd_xcorr_channelizer_pipeline_4ant",
        "value": round(msps, 2),
        "unit": "MSPS/device",
        "vs_baseline": round(msps / NORTH_STAR_MSPS, 3),
        "device": {"platform": d.platform, "kind": d.device_kind},
    }))


if __name__ == "__main__":
    main()
