"""Trace event callbacks.

Called after every trace step with the wavefront's result codes
(reference: src/theia/trace.py:49-305). Only the interface and the empty
callback are ported so far.
"""

from __future__ import annotations

import torch

from .component import Component

__all__ = ["TraceEventCallback", "EmptyEventCallback"]


class TraceEventCallback(Component):
    """Base class; ``on_event`` folds one step's events into the state."""

    name = "Trace Event Callback"

    def init(self, batch_size: int, max_steps: int):
        return None

    def on_event(self, params, state, ray, code: torch.Tensor, mask: torch.Tensor, i):
        return state

    def result(self, params, state):
        return state


class EmptyEventCallback(TraceEventCallback):
    name = "Empty Event Callback"
