"""Many processes, one photon mesh: the port of
``theia_tpu/parallel/multihost.py``.

``theia_tpu`` joins every host into JAX's multi-controller runtime. The
port's processes, one a device on one host or on many, join one
``torch.distributed`` process group (:func:`initialize`), and the same
:func:`~theia_tpu_torch.parallel.dataparallel.shard_trace` program runs on
every rank:

* the scene and material tables are host code that builds the same bits in
  every process, so "replicating" them is moving each leaf to the rank's
  device (:func:`replicate_tree`), with no broadcast;
* lane addressing is the global stream ids: :func:`global_streams` gives
  each rank its contiguous block of ``0..capacity``, so results do not
  depend on the process count;
* the summed histogram comes back the same on every rank; each reads its
  own host copy (:func:`fetch`).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..component import map_tensors
from .dataparallel import PhotonMesh, make_photon_mesh, sharded_streams

__all__ = [
    "initialize",
    "global_photon_mesh",
    "global_streams",
    "replicate_tree",
    "fetch",
    "shard_trace_multihost",
]

#: seconds a collective may wait for the other ranks before it fails
TIMEOUT = 60.0


def initialize(
    coordinator: str = "localhost:29400",
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    With no ``num_processes`` the world comes from torchrun's environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); otherwise ``coordinator`` is process 0's
    ``host:port`` (``tcp://``), or any URL ``init_process_group`` takes
    (``file://...``), and this process is ``process_id`` of
    ``num_processes``. ``backend``: NCCL where a card is available, gloo
    otherwise (gloo also sums CUDA tensors, through the host). With NCCL
    the process takes the card ``LOCAL_RANK`` (torchrun) or ``process_id``
    modulo the cards of its host. A collective that waits past
    :data:`TIMEOUT` seconds fails instead of hanging."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = dict(backend=backend, timeout=datetime.timedelta(seconds=TIMEOUT))
    if num_processes is None:
        kwargs["init_method"] = "env://"
        local = int(os.environ.get("LOCAL_RANK", 0))
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kwargs.update(init_method=url, world_size=num_processes, rank=process_id)
        local = process_id
    if backend == "nccl":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


def global_photon_mesh(device=None) -> PhotonMesh:
    """The mesh of every rank of the process group, on this rank's
    ``device`` (by default its card)."""
    return make_photon_mesh(None if device is None else [device])


def global_streams(capacity: int, mesh: PhotonMesh) -> torch.Tensor:
    """This rank's contiguous block of the global path indices
    0..capacity, int32 on its device."""
    if capacity % mesh.size != 0:
        raise ValueError("capacity must be divisible by the device count")
    return sharded_streams(capacity, mesh)


def replicate_tree(tree, mesh: PhotonMesh):
    """``tree`` with every tensor on the rank's device: the parameters that
    every process built the same from host code, made the rank's inputs."""
    return map_tensors(lambda x: x.to(mesh.device, non_blocking=True), tree)


def fetch(x):
    """Host copies (numpy) of every tensor of a summed result, which is the
    same on every rank."""
    return map_tensors(lambda a: a.detach().cpu().numpy(), x)


def shard_trace_multihost(tracer, mesh: PhotonMesh | None = None):
    """Batch runner over every rank of the process group: returns
    ``run(params=None, *, advance=True) -> (response_result,
    callback_result)`` mirroring ``tracer.run()``: each call traces one
    global batch of ``tracer.capacity`` paths spread over the ranks,
    advances the RNG and returns the summed results as host numpy arrays.
    One ``params()`` snapshot a batch: stateful stages (a streaming host
    source) advance inside ``params()``, so the batch and its results read
    the same snapshot."""
    from .runner import ShardedRunner

    runner = ShardedRunner(
        tracer, global_photon_mesh(tracer.device) if mesh is None else mesh, multihost=True
    )

    def run(params=None, *, advance: bool = True):
        p = tracer.params() if params is None else params
        out = runner.launch(p)
        if advance:
            tracer.rng.advance()
        return runner.materialize(out, p)

    return run
