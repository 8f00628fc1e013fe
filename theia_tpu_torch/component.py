"""Component/stage base classes.

Every component is a Python object holding *static* configuration plus a
dictionary of runtime parameters. :meth:`Component.params` snapshots them
as float32 tensors on the device the caller names, so a tracer can change
them between batches (the reference's double-buffered UBO analogue).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["Component", "TraceConfig", "resolve_device"]


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


def _to_tensor(value, device):
    if isinstance(value, (tuple, list, np.ndarray, float, int)):
        return torch.as_tensor(np.asarray(value, np.float32), device=device)
    return value


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
        """Snapshot runtime parameters as float32 tensors on ``device``."""
        return {name: _to_tensor(getattr(self, name), device) for name in self._param_names}

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
