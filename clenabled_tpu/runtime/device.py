"""Device & mesh core.

Replaces the reference's per-block OpenCL device selection
(lib/GRCLBase.cpp:115-196 — platform scan, device-by-type or
platformId:devId pick, capability probes, per-block context/queue) with a
single shared :class:`DeviceContext` holding one `jax.sharding.Mesh`.

The reference scales by pinning different *blocks* to different devices
(README.md:110).  Here scale comes from sharding the *data* (time-blocks,
channels, stations) across the mesh — see `clenabled_tpu.sharding` — so there
is exactly one context shared by the whole flowgraph.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


@dataclasses.dataclass
class DeviceContext:
    """Process-wide device/mesh context.

    Attributes:
      mesh: the device mesh all sharded flowgraphs run over.  Defaults to a
        1-D mesh over every local device with axis name ``"shard"``.
      platform: jax platform string ("gpu", "cpu", ...).
    """

    mesh: Mesh
    platform: str

    @property
    def num_devices(self) -> int:
        return int(np.prod(list(self.mesh.shape.values()))) if self.mesh.shape else 1

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DeviceContext(platform={self.platform!r}, "
            f"mesh={dict(self.mesh.shape)!r})"
        )


_lock = threading.Lock()
_context: Optional[DeviceContext] = None


def _default_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), axis_names=("shard",))


def get_context() -> DeviceContext:
    """Return (lazily creating) the shared device context."""
    global _context
    with _lock:
        if _context is None:
            mesh = _default_mesh()
            _context = DeviceContext(mesh=mesh, platform=jax.devices()[0].platform)
        return _context


def set_default_mesh(mesh: Mesh) -> DeviceContext:
    """Install a mesh as the shared context (e.g. a 2-D (host, chip) mesh)."""
    global _context
    with _lock:
        _context = DeviceContext(
            mesh=mesh, platform=list(mesh.devices.flat)[0].platform
        )
        return _context


def device_info() -> list[dict]:
    """Per-device capability summary — the role of `clview`
    (lib/clview.cc:43-246: platform/device ids, clock, compute units,
    workgroup limits, fp64/FMA/SVM).  Here: platform, device kind,
    process index and memory stats where the backend exposes them.
    """
    out = []
    for d in jax.devices():
        info = {
            "id": d.id,
            "platform": d.platform,
            "device_kind": getattr(d, "device_kind", "unknown"),
            "process_index": d.process_index,
        }
        stats = d.memory_stats()    # None on backends that keep none
        if stats:
            info["bytes_limit"] = stats.get("bytes_limit")
            info["bytes_in_use"] = stats.get("bytes_in_use")
        out.append(info)
    return out
