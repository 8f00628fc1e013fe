"""Component/stage base classes.

Every component is a Python object holding *static* configuration plus a
dictionary of runtime parameters. :meth:`Component.params` snapshots them
as float32 tensors on the device the caller names, so a tracer can change
them between batches (the reference's double-buffered UBO analogue).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["Component", "TraceConfig", "resolve_device", "map_tensors", "host_tensors", "host_dict"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Entry points default to the card
    (``"cuda"``); asked for a card that is not there they raise here
    rather than run on the CPU, which a caller gets with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a card (the default device is 'cuda'), but "
            "torch.cuda.is_available() is false; pass device='cpu' to run on the CPU"
        )
    return device


def map_tensors(fn, tree):
    """``tree`` (tensors in tuples, lists, dicts and dataclasses, any other
    leaf kept as it is) with ``fn`` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init}
        )
    return tree


def _is_host(value) -> bool:
    return isinstance(value, (tuple, list, np.ndarray, np.generic, float, int))


def host_tensors(values, device) -> list:
    """``values``, pairs (host value, dtype), as tensors on ``device``: a
    number (numpy's scalars too), tuple, list or array becomes a tensor of
    ``dtype`` (None: the array's own); anything else (a tensor, with its
    graph, or None) passes through as it is. On a card all of them come
    from ONE pinned host buffer, a fresh one each call, by one non-blocking
    copy: a launch that snapshots its parameters queues the copy and waits
    for no batch queued before it, and a later ``setParams`` fills another
    buffer, so a snapshot already queued keeps its values (the caching
    host allocator reuses a buffer only after the copy that read it). On
    the CPU the tensors are views of the one host buffer, each of its own
    span."""
    device = torch.device(device)
    arrays = [(np.array(v, dtype, order="C") if _is_host(v) else None) for v, dtype in values]
    spans, size = [], 0
    for a in arrays:
        spans.append(size)
        if a is not None:
            size += -(-a.nbytes // 16) * 16  # 16-byte aligned spans
    if all(a is None for a in arrays):
        return [v for v, _ in values]
    host = torch.empty(size, dtype=torch.uint8, pin_memory=device.type == "cuda")
    flat = host.numpy()
    for a, at in zip(arrays, spans):
        if a is not None:
            flat[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host if device.type == "cpu" else host.to(device, non_blocking=device.type == "cuda")
    return [
        v if a is None else buf[at:at + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).reshape(a.shape)
        for (v, _), a, at in zip(values, arrays, spans)
    ]


def host_dict(spec: dict, device) -> dict:
    """``{name: (host value, dtype)}`` as ``{name: tensor}`` through one
    :func:`host_tensors` call."""
    return dict(zip(spec, host_tensors(list(spec.values()), device)))


class Component:
    """Base for pipeline components (reference: hephaistos PipelineStage,
    docs/pipeline/pipeline.md:24-64).

    Subclasses declare ``_param_names``; :meth:`params` snapshots them as a
    dict of tensors, while get/setParams provide the reference's uniform
    stage-parameter API.
    """

    name: str = "Component"
    _param_names: tuple[str, ...] = ()
    _extra_names: tuple[str, ...] = ()

    def params(self, device) -> dict[str, Any]:
        """Snapshot runtime parameters as float32 tensors on ``device``
        (:func:`host_tensors`: one non-blocking copy on a card, no host
        sync; a parameter that is already a tensor passes through)."""
        return host_dict({k: (getattr(self, k), np.float32) for k in self._param_names}, device)

    def setParams(self, **kwargs) -> None:
        allowed = set(self._param_names) | set(self._extra_names)
        for key, value in kwargs.items():
            if key not in allowed:
                raise ValueError(f"{type(self).__name__} has no parameter {key!r}")
            setattr(self, key, value)

    def getParam(self, name: str):
        if name not in set(self._param_names) | set(self._extra_names):
            raise ValueError(f"{type(self).__name__} has no parameter {name!r}")
        return getattr(self, name)

    def update(self) -> None:
        """Hook called once per batch before parameters are snapshot
        (the reference's ``_finishParams``)."""


class TraceConfig:
    """Static configuration a tracer hands to its response
    (reference: src/theia/response.py:95-178)."""

    def __init__(
        self,
        batch_size: int,
        capacity: int,
        max_hits_per_thread: int,
        normalization: float,
        polarized: bool,
    ) -> None:
        self.batch_size = batch_size
        self.capacity = capacity
        self.max_hits_per_thread = max_hits_per_thread
        self.normalization = normalization
        self.polarized = polarized
