"""Profiling utilities: the port of ``theia_tpu/profiling.py``.

``theia_tpu`` profiles with XLA's profiler (a TensorBoard/Perfetto trace
with per-HLO times) and with steady-state wall-clock statistics. The port
profiles with ``torch.profiler``: host activity, plus the card's kernels
(CUPTI) where the tracer runs on one, written as a Chrome/TensorBoard
trace (``*.pt.trace.json``) that Perfetto, ``chrome://tracing`` or
TensorBoard's profiler plugin open; the wall-clock statistics end every
batch with ``torch.cuda.synchronize`` on a card, since a launch returns
before the device has run it.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

__all__ = ["trace_profile", "profile_batch", "batch_timings"]


@contextlib.contextmanager
def trace_profile(logdir: str, *, annotate: str | None = None, cuda: bool | None = None):
    """Profile the region into a trace file in ``logdir`` and yield the
    ``torch.profiler.profile`` (for ``key_averages()``)::

        with trace_profile("/tmp/prof"):
            tracer.run()

    ``annotate`` names the region (a ``record_function`` range);
    ``cuda``: whether to trace the card's kernels too (by default where a
    card is available)."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        if annotate is None:
            yield prof
        else:
            with record_function(annotate):
                yield prof


def _wait(tracer) -> None:
    """Wait for the tracer's device to finish what it was given."""
    if tracer.device.type == "cuda":
        torch.cuda.synchronize(tracer.device)


def batch_timings(tracer, *, runs: int = 5, warmup: int = 1) -> dict:
    """Steady-state seconds a batch (``min``, ``median``, ``mean``,
    ``max`` of ``runs`` batches after ``warmup``; the kernels' build falls
    in the warm-up), with ``bounces_per_s`` at the fastest batch. The RNG
    advances every run, so no batch repeats another."""
    ts = []
    for i in range(warmup + runs):
        t0 = time.perf_counter()
        tracer.run()
        _wait(tracer)
        if i >= warmup:
            ts.append(time.perf_counter() - t0)
    arr = np.asarray(ts)
    return {
        "min": float(arr.min()),
        "median": float(np.median(arr)),
        "mean": float(arr.mean()),
        "max": float(arr.max()),
        "runs": runs,
        "batch_size": tracer.batchSize,
        "bounces_per_s": tracer.batchSize
        * getattr(tracer, "maxPathLength", getattr(tracer, "pathLength", 1))
        / float(arr.min()),
    }


def profile_batch(tracer, logdir: str, *, runs: int = 2) -> dict:
    """Profile ``runs`` steady-state batches into ``logdir`` (after one
    batch outside the trace, which builds the kernels) and return their
    wall-clock statistics (:func:`batch_timings`)."""
    tracer.run()
    _wait(tracer)
    with trace_profile(logdir, annotate="theia_tpu_torch.batch", cuda=tracer.device.type == "cuda"):
        stats = batch_timings(tracer, runs=runs, warmup=0)
    return stats
