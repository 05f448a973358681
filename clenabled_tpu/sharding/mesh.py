"""Mesh construction helpers."""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(shape: dict[str, int] | None = None,
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a mesh.  Default: 1-D over all devices, axis "shard".

    shape e.g. {"host": 2, "shard": 4} builds a 2-D mesh (outer axis
    across hosts, inner across the devices of one host) — pass axis sizes whose product equals the device
    count.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = {"shard": len(devices)}
    sizes = list(shape.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.array(devices).reshape(sizes)
    return Mesh(arr, tuple(shape.keys()))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host bring-up (jax.distributed).  Nothing tells JAX of a
    cluster here, so pass coordinator_address ("host:port"),
    num_processes and process_id explicitly."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
