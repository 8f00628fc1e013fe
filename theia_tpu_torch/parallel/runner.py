"""Sharded batch runner pluggable into the orchestration layer.

The port of ``theia_tpu/parallel/runner.py``:
``Pipeline(tracer, runner=ShardedRunner(tracer))`` routes every batch
launch through :func:`~theia_tpu_torch.parallel.dataparallel.shard_trace`
over the photon mesh, while the scheduler (synchronous or on its dispatch
thread), dynamic tasks and checkpoints stay unchanged: they see only the
pipeline's launch / materialize surface and the host-side RNG cursors.

Every rank runs the same pipeline on the same tasks and issues the same
collectives in the same order: one all-reduce a state tensor a batch, in
launch order. A task's decisions come from the summed results, which are
the same bits on every rank, so every rank issues the same batches and
stops at the same one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .dataparallel import make_photon_mesh, shard_trace, sharded_streams

__all__ = ["ShardedRunner"]


class ShardedRunner:
    """Batch runner executing a tracer's step over the photon mesh.

    Implements the two-method runner protocol consumed by
    :class:`theia_tpu_torch.pipeline.Pipeline`:

    * ``launch(params) -> device_states``: queue one batch of this rank's
      lanes, with the response and callback states summed over the group,
      without waiting for it;
    * ``materialize(out, params) -> (response_result, callback_result)``:
      the results of a launched batch.

    ``mesh`` defaults to :func:`make_photon_mesh` on the tracer's device.
    ``multihost=None`` means a world of more than one process; with
    ``multihost`` the parameters are moved to the rank's device
    (:func:`~theia_tpu_torch.parallel.multihost.replicate_tree`) and the
    results come back as host copies
    (:func:`~theia_tpu_torch.parallel.multihost.fetch`), as
    ``theia_tpu``'s multi-controller mode returns them.
    """

    def __init__(self, tracer, mesh=None, *, multihost: bool | None = None):
        self.tracer = tracer
        self.mesh = make_photon_mesh([tracer.device]) if mesh is None else mesh
        a, b = self.mesh.device, tracer.device
        if a.type != b.type or None not in (a.index, b.index) and a.index != b.index:
            raise ValueError(f"the mesh's device {a} is not the tracer's {b}")
        if multihost is None:
            multihost = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
        self.multihost = multihost
        self._fn = shard_trace(tracer, self.mesh)
        self._streams = sharded_streams(tracer.capacity, self.mesh)

    def launch(self, params):
        """Queue one batch; returns the summed (response, callback) device
        states without waiting for them."""
        if self.multihost:
            from .multihost import replicate_tree

            params = replicate_tree(params, self.mesh)
        with torch.no_grad():
            return self._fn(params, self.tracer.rng.counter_words, self._streams)[:2]

    def materialize(self, out, params):
        """A launched batch's (response, callback) results."""
        resp_state, cb_state = out
        tracer = self.tracer
        with torch.no_grad():
            result = (
                tracer.response.result(params["response"], resp_state),
                tracer.callback.result(params["callback"], cb_state),
            )
        if self.multihost:
            from .multihost import fetch

            result = fetch(result)
        return result
