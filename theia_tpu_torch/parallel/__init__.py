"""Multi-device distribution of the photon axis (``theia_tpu.parallel``).

The only parallel axis the workload needs is the photon axis: pure data
parallelism. ``shard_trace`` runs a tracer's batch function on this
process's block of the global lane ids and sums the response and callback
states over the process group with ``all_reduce`` (``theia_tpu``'s
``psum``). RNG streams are the global path indices, so results do not
depend on the device count. The port runs one process a device (PyTorch's
idiom; JAX's mesh is one process over many devices): the processes join
one ``torch.distributed`` group through :func:`initialize`, on one host or
many, and ``ShardedRunner`` plugs the same program into
``Pipeline(runner=...)``.
"""

from .dataparallel import BATCH_AXIS, PhotonMesh, make_photon_mesh, reduce_gradients, shard_trace, sharded_streams
from .multihost import (
    fetch,
    global_photon_mesh,
    global_streams,
    initialize,
    replicate_tree,
    shard_trace_multihost,
)
from .runner import ShardedRunner

__all__ = [
    "make_photon_mesh",
    "shard_trace",
    "sharded_streams",
    "fetch",
    "global_photon_mesh",
    "global_streams",
    "replicate_tree",
    "shard_trace_multihost",
    "ShardedRunner",
]
