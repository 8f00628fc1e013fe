"""Tracers of the PyTorch port (so far: the scene forward tracer)."""

from .core import EventResultCode, TracerBase

__all__ = ["EventResultCode", "TracerBase", "SceneForwardTracer"]


def __getattr__(name: str):
    # lazy: trace.scene imports accel, which imports trace.core
    if name == "SceneForwardTracer":
        from .scene import SceneForwardTracer

        return SceneForwardTracer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
