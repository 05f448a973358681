"""Sharding layer: multi-device execution over a jax Mesh.

This is the capability the reference does NOT have (its only scaling story
is pinning whole blocks to different OpenCL devices, README.md:110).  Here
the *data* shards across devices and the reference's sequential carried
state becomes communication between them (NCCL over NVLink on a GPU host):

- time-sharded filtering: the overlap-add/FIR tail that the reference
  carries between work() calls (lib/fft_filter.cc:156-171) becomes a
  single ring ``ppermute`` halo exchange between neighboring time-shards —
  bit-compatible with sequential execution;
- the channelizer time-shards the input stream with the same halo pattern
  (its GR history, lib/clPolyphaseChannelizer_impl.cc:63);
- the X-Engine's station cross-multiply uses ``all_to_all`` to move from
  station-sharded capture to channel-sharded correlation (each device then
  owns the full Gram matrix for its channel slice) — this is the
  CP/EP-analogue for interferometry;
- multi-host: the same shard_map code over a (host, device) mesh via
  jax.distributed.
"""

from clenabled_tpu.sharding.mesh import (  # noqa: F401
    make_mesh,
    initialize_distributed,
)
from clenabled_tpu.sharding.halo import (  # noqa: F401
    make_sharded_fft_filter,
    make_sharded_fir_filter,
    make_sharded_channelizer,
)
from clenabled_tpu.sharding.xengine_sharded import (  # noqa: F401
    sharded_xengine,
    make_sharded_xengine,
    make_sharded_xengine_stacked,
)
from clenabled_tpu.sharding.planar_halo import (  # noqa: F401
    make_sharded_fft_filter_planar,
    make_sharded_channelizer_planar,
    make_sharded_costas_channels,
    sharded_xengine_planar,
)
from clenabled_tpu.sharding.chain import (  # noqa: F401
    ShardedChain,
    make_sharded_quadrature_demod,
)
from clenabled_tpu.sharding.xcorr_sharded import (  # noqa: F401
    make_sharded_td_xcorr,
    make_sharded_fd_xcorr,
)
