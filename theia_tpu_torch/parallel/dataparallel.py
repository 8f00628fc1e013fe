"""Photon-wavefront data parallelism over ``torch.distributed``.

The port of ``theia_tpu/parallel/dataparallel.py``. JAX's mesh is one
process driving many devices, and ``shard_map`` runs the batch function on
each device's block of lanes, with ``psum`` over the devices. PyTorch's
idiom is one process a device: a :class:`PhotonMesh` is the process group,
this process's rank in it, the world size and the rank's device. Each rank
traces its contiguous block of the *global* lane ids
(:func:`sharded_streams`) and the response and callback states are summed
over the group with ``all_reduce`` (NCCL on cards, gloo on the CPU), so a
batch's results do not depend on the device count, as in ``theia_tpu``.

The sum's backward passes the incoming gradient through unchanged, so a
``backward()`` of a loss of the summed state on every rank leaves each
rank's own share of the gradient in a replicated parameter's ``.grad``;
:func:`reduce_gradients` sums those shares over the group, after which
every rank holds the single-device gradient. (An all-reduce whose
backward all-reduces the gradient as well, like
``torch.distributed.nn.functional.all_reduce``, counts it world-size times
where each rank differentiates the replicated sum.)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..component import map_tensors, resolve_device

__all__ = [
    "BATCH_AXIS",
    "PhotonMesh",
    "make_photon_mesh",
    "sharded_streams",
    "shard_trace",
    "reduce_gradients",
]

BATCH_AXIS = "batch"


@dataclass(frozen=True)
class PhotonMesh:
    """One process's place in the photon axis: the process ``group``
    (``None`` for a world of one process, which needs no collective), its
    ``rank``, the world ``size`` (``Mesh.size`` in JAX: the device count)
    and the ``device`` it traces on."""

    group: object
    rank: int
    size: int
    device: torch.device


def _default_device() -> torch.device:
    """The port's default device, the card (this process's current one)."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device("cuda")


def make_photon_mesh(devices=None) -> PhotonMesh:
    """The photon mesh of this process. In a process whose
    ``torch.distributed`` is initialized it is that world; otherwise a
    world of one process. ``devices``: this process's device, as a
    one-element list (JAX's signature) or a device; by default the card
    (``"cuda"``, the current device). A process drives one device: more
    than one raises, since a mesh of several devices is a world of
    processes, one a device, each joined by
    :func:`theia_tpu_torch.parallel.initialize`."""
    if devices is not None and not isinstance(devices, (str, torch.device)):
        devices = list(devices)
        if len(devices) != 1:
            raise ValueError(
                f"make_photon_mesh got {len(devices)} devices, but a process of the port drives one device: "
                "start one process a device and join them with theia_tpu_torch.parallel.initialize(...) "
                "(torch.distributed), then call make_photon_mesh([that process's device]) in each"
            )
        devices = devices[0]
    device = _default_device() if devices is None else resolve_device(devices)
    if dist.is_available() and dist.is_initialized():
        return PhotonMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device)
    return PhotonMesh(None, 0, 1, device)


def sharded_streams(batch_size: int, mesh: PhotonMesh) -> torch.Tensor:
    """This rank's contiguous block of the global lane ids 0..batch_size,
    int32 on the rank's device (the port's stream ids are int32)."""
    if batch_size % mesh.size != 0:
        raise ValueError("batch size must be divisible by the device count")
    per = batch_size // mesh.size
    return torch.arange(mesh.rank * per, (mesh.rank + 1) * per, dtype=torch.int32, device=mesh.device)


class _SumOverGroup(torch.autograd.Function):
    """``all_reduce`` (sum) of a copy of ``x`` over ``group``; the backward
    passes the gradient through (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _sum_over(mesh: PhotonMesh, tree):
    """Every tensor of ``tree`` summed over the mesh's group (JAX's psum);
    the tree itself in a world of one process."""
    if mesh.group is None:
        return tree
    return map_tensors(lambda x: _SumOverGroup.apply(x, mesh.group), tree)


def shard_trace(tracer, mesh: PhotonMesh, *, reduce_response: bool = True):
    """``fn(params, counter, streams)`` running ``tracer._trace_batch`` on
    this rank's ``streams`` (:func:`sharded_streams`), with the response
    state (unless ``reduce_response`` is False, e.g. for a ``HitRecorder``,
    whose slots stay the rank's) and the callback state summed over the
    mesh. It returns ``(response_state, callback_state)``, and with the
    tracer's ``_debug_rng`` hook also each of this rank's lanes' final RNG
    dim, unreduced. Autograd stays on (see :func:`reduce_gradients`)."""
    trace = tracer._trace_batch

    def fn(params, counter, streams):
        resp_state, cb_state, *rest = trace(params, counter, streams)
        if reduce_response:
            resp_state = _sum_over(mesh, resp_state)
        if cb_state is not None:
            cb_state = _sum_over(mesh, cb_state)
        return (resp_state, cb_state, *rest)

    return fn


def reduce_gradients(tensors, mesh: PhotonMesh) -> None:
    """Sum the ``.grad`` of each tensor over the mesh, in place, in the
    order given (the same on every rank): after a ``backward()`` of a loss
    of :func:`shard_trace`'s summed state on every rank, each replicated
    parameter then holds the single-device gradient on every rank. A
    tensor without a gradient takes part with zeros."""
    if mesh.group is None:
        return
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        dist.all_reduce(t.grad, op=dist.ReduceOp.SUM, group=mesh.group)
