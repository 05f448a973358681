"""Runtime core: device/mesh management, dtypes, sizing policy.

The reference's runtime core is ``GRCLBase`` (/root/reference/lib/GRCLBase.cpp):
every block owns an OpenCL context, command queue and JIT-compiled kernel, and
is pinned to one device chosen by ``(platformType, devSelector, platformId,
devId)``.  Under JAX there is exactly one program (XLA) and one device
topology (the mesh), so the runtime core here is a single shared :class:`DeviceContext`
plus a dtype registry and a block-size policy — no per-block contexts, no
runtime source-string compilation.
"""

from clenabled_tpu.runtime.dtypes import (  # noqa: F401
    DTYPE_COMPLEX,
    DTYPE_FLOAT,
    DTYPE_INT,
    DTYPE_SHORT,
    DTYPE_BYTE,
    DTYPE_PACKEDXY,
    dtype_of,
    itemsize_of,
)
from clenabled_tpu.runtime.device import (  # noqa: F401
    DeviceContext,
    get_context,
    set_default_mesh,
    device_info,
)
