"""Tracers of the PyTorch port: the scene forward tracer, the volume
forward and backward tracers, the direct-light tracer, the two photon
tracers, the two scene backward tracers and the bidirectional path
tracer."""

from .core import EventResultCode, TracerBase

#: the reference's name for the tracer base class (ref trace.py ``Tracer``)
Tracer = TracerBase

__all__ = [
    "EventResultCode",
    "TracerBase",
    "Tracer",
    "SceneForwardTracer",
    "VolumeForwardTracer",
    "VolumeBackwardTracer",
    "DirectLightTracer",
    "VolumePhotonTracer",
    "ScenePhotonTracer",
    "SceneBackwardTargetTracer",
    "SceneBackwardTracer",
    "BidirectionalPathTracer",
]

_LAZY = {
    "SceneForwardTracer": "scene",
    "VolumeForwardTracer": "volume",
    "VolumeBackwardTracer": "backward",
    "DirectLightTracer": "direct",
    "VolumePhotonTracer": "photon",
    "ScenePhotonTracer": "photon",
    "SceneBackwardTargetTracer": "scene_backward",
    "SceneBackwardTracer": "scene_backward",
    "BidirectionalPathTracer": "bidirectional",
}


def __getattr__(name: str):
    # lazy: trace.scene imports accel, and callback imports trace.core
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
