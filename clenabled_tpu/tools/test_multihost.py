"""Multi-host validation — launches N processes with jax.distributed over
localhost, builds a GLOBAL mesh spanning all processes' devices, and runs
the sharded flagship pipeline one step.

This exercises the true multi-host code path (global mesh construction,
cross-process collectives over the distributed runtime) without a
cluster: each worker runs on the CPU backend with virtual devices, so no
worker opens an accelerator.

    python -m clenabled_tpu.tools.test_multihost --procs 2 --devices-per-proc 4
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_WORKER_CODE = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count={dev}")
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:{port}",
                           num_processes={procs}, process_id={pid})
import numpy as np
from jax.sharding import Mesh
from clenabled_tpu.pipelines import FxPipelineConfig, make_sharded_fx_pipeline

devs = jax.devices()  # global across processes
mesh = Mesh(np.array(devs), ("shard",))
cfg = FxPipelineConfig(num_antennas=4, num_channels=16, samples_per_step=512)
fn, (xr, xi, hr, hi) = make_sharded_fx_pipeline(mesh, cfg=cfg)
fd, xre, xim, nhr, nhi = fn(xr, xi, hr, hi)
jax.block_until_ready((fd, xre, xim, nhr, nhi))
print(f"proc {{jax.process_index()}}/{procs}: global devices="
      f"{{len(devs)}} fd={{fd.shape}} xmat={{xre.shape}} OK", flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-host sharded pipeline")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--port", type=int, default=12357)
    args = ap.parse_args()

    workers = []
    for pid in range(args.procs):
        code = _WORKER_CODE.format(dev=args.devices_per_proc, port=args.port,
                                   procs=args.procs, pid=pid)
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        workers.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ok = True
    for pid, w in enumerate(workers):
        out, _ = w.communicate(timeout=600)
        tail = [ln for ln in out.splitlines() if "OK" in ln or "Error" in ln]
        print(f"[worker {pid}] " + (tail[-1] if tail else out.splitlines()[-1]
                                    if out.splitlines() else "<no output>"))
        ok &= w.returncode == 0
    print("multi-host run:", "PASS" if ok else "FAIL")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
