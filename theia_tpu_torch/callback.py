"""Trace event callbacks.

Called after every trace step with the wavefront's result codes; used for
statistics and path recording (reference: src/theia/trace.py:49-305,
shader/callback.stat.glsl, shader/callback.track.glsl). The reference's
atomic counters become masked reductions over the wavefront, as in
``theia_tpu.callback``.
"""

from __future__ import annotations

import numpy as np
import torch

from .component import Component
from .trace.core import EventResultCode

__all__ = [
    "TraceEventCallback",
    "EmptyEventCallback",
    "EventStatisticCallback",
    "TrackRecordCallback",
]


class TraceEventCallback(Component):
    """Base class; ``on_event`` folds one step's events into the state."""

    name = "Trace Event Callback"

    def init(self, batch_size: int, max_steps: int, device):
        return None

    def on_event(self, params, state, ray, code: torch.Tensor, mask: torch.Tensor, i: int, pol=None):
        """``pol``: the forward rays' ``(stokes, pol_ref)`` in polarized
        runs, else None (reference: TRACK_POLARIZED)."""
        return state

    def result(self, params, state):
        return state


class EmptyEventCallback(TraceEventCallback):
    name = "Empty Event Callback"


#: statistic field order (reference: shader/callback.stat.glsl:7-19)
STAT_FIELDS = (
    "created",
    "scattered",
    "hit",
    "detected",
    "volume",
    "lost",
    "decayed",
    "absorbed",
    "missed",
    "maxIter",
    "error",
    "mismatch",
)

#: the result code counted in each field; "error" (10) counts every
#: code at or below ERROR_CODE_MAX_VALUE instead
_FIELD_CODES = (
    int(EventResultCode.RAY_CREATED),
    int(EventResultCode.RAY_SCATTERED),
    int(EventResultCode.RAY_HIT),
    int(EventResultCode.RAY_DETECTED),
    int(EventResultCode.VOLUME_HIT),
    int(EventResultCode.RAY_LOST),
    int(EventResultCode.RAY_DECAYED),
    int(EventResultCode.RAY_ABSORBED),
    int(EventResultCode.RAY_MISSED),
    int(EventResultCode.MAX_ITER),
    None,
    int(EventResultCode.ERROR_MEDIA_MISMATCH),
)
_ERROR = STAT_FIELDS.index("error")


class EventStatisticCallback(TraceEventCallback):
    """Counts events per result code
    (reference: src/theia/trace.py:77-186, shader/callback.stat.glsl).

    ``live=True`` copies the running totals to the host after every
    trace step, so :attr:`statistics` can be polled from another thread
    while a long batch runs (the reference's host-mapped stat buffer;
    ``jax.debug.callback`` in ``theia_tpu``). Each copy waits for the
    device, so it is off by default, and with it off nothing waits."""

    name = "Event Statistic Callback"

    def __init__(self, *, live: bool = False) -> None:
        self.live = live
        self._live_counts = np.zeros(len(STAT_FIELDS), np.int64)

    def init(self, batch_size: int, max_steps: int, device):
        self._live_counts = np.zeros(len(STAT_FIELDS), np.int64)
        self._codes = torch.tensor(
            [-1000 if c is None else c for c in _FIELD_CODES], dtype=torch.int32, device=device
        )
        return torch.zeros(len(STAT_FIELDS), dtype=torch.int64, device=device)

    def on_event(self, params, state, ray, code, mask, i, pol=None):
        hits = (code[:, None] == self._codes) & mask[:, None]
        hits[:, _ERROR] = mask & (code <= int(EventResultCode.ERROR_CODE_MAX_VALUE))
        state = state + hits.sum(0)
        if self.live:
            self._live_counts = state.cpu().numpy()
        return state

    @property
    def statistics(self) -> dict[str, int]:
        """Latest counters of the running batch (``live=True``); after the
        batch they equal :meth:`result`."""
        return {f: int(v) for f, v in zip(STAT_FIELDS, self._live_counts)}

    def result(self, params, state) -> dict[str, int]:
        return {f: int(v) for f, v in zip(STAT_FIELDS, state.cpu().numpy())}


class TrackRecordCallback(TraceEventCallback):
    """Records full paths (position + time per step) for visualization
    (reference: src/theia/trace.py:189-305, shader/callback.track.glsl).

    With ``polarized=True`` each step also stores the Stokes vector and
    reference frame (11 columns: xyz t IQUV ref_xyz); steps without
    polarization data store the unpolarized state and a zero frame
    (reference: TRACK_POLARIZED, trace.py:200-202)."""

    name = "Track Record Callback"

    def __init__(self, *, polarized: bool = False) -> None:
        self.polarized = polarized

    def init(self, batch_size: int, max_steps: int, device):
        cols = 11 if self.polarized else 4
        return dict(
            length=torch.zeros(batch_size, dtype=torch.int32, device=device),
            code=torch.zeros(batch_size, dtype=torch.int32, device=device),
            track=torch.zeros((max_steps, batch_size, cols), dtype=torch.float32, device=device),
        )

    def on_event(self, params, state, ray, code, mask, i, pol=None):
        record = mask & (code != int(EventResultCode.MAX_ITER))
        point = torch.cat([ray.position, ray.time[..., None]], dim=-1)
        if self.polarized:
            if pol is None:
                stokes = torch.zeros((point.shape[0], 4), dtype=torch.float32, device=point.device)
                stokes[:, 0] = 1.0
                pol = (stokes, torch.zeros_like(ray.position))
            point = torch.cat([point, *pol], dim=-1)
        track = state["track"]  # written in place: no step reads an older state
        if i < track.shape[0]:
            track[i] = torch.where(record[..., None], point.detach(), track[i])
        return dict(
            length=torch.where(record, i, state["length"]).to(torch.int32),
            code=torch.where(record, code, state["code"]),
            track=track,
        )

    def result(self, params, state):
        return {
            "length": state["length"].cpu().numpy(),
            "code": state["code"].cpu().numpy(),
            "track": state["track"].permute(1, 0, 2).cpu().numpy(),
        }
