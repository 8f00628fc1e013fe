"""Direct light tracer: zero-scatter camera-light connections
(reference: src/theia/trace.py:1883-2095, shader/tracer.direct.glsl).

The port of ``theia_tpu.trace.direct``. With a scene, each connection is
tested for occlusion with :func:`~theia_tpu_torch.accel.is_visible` (on a
brute-force scene the soup's any-hit kernel); without one, the detector's
normal alone decides self-shadowing.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import units as u
from ..accel import is_visible
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera
from ..component import Component, TraceConfig, host_dict, resolve_device
from ..light import LightSource, WavelengthSource
from ..material import Medium
from ..ops.math3d import dot, sqrt
from ..random import RNG
from ..scene import Scene
from .backward import sample_direct
from .core import PropagateParams, TracerBase

__all__ = ["DirectLightTracer"]


class DirectLightTracer(TracerBase):
    """Zero-scatter connection estimator. Lanes and parameters live on
    ``device`` (the scene's, when one is given): the card unless the caller
    names another."""

    name = "Direct Light Tracer"
    _param_names = ("maxTime",)

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response,
        rng: RNG,
        scene: Scene | None = None,
        *,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        medium: Medium | None = None,
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        device="cuda",
    ) -> None:
        if not source.supportBackward:
            raise ValueError("Light source does not support backward mode")
        if not camera.supportDirect:
            raise ValueError("Camera does not support direct lighting")
        self.device = resolve_device(device)
        self._init_batch(batchSize, capacity)
        self.source = source
        self.camera = camera
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.scene = scene
        self.medium = medium
        self.callback = EmptyEventCallback() if callback is None else callback
        self.maxTime = maxTime
        self.polarized = polarized
        self.maxHitsPerThread = 1
        self.nRNGSamples = (
            source.nRNGBackward + camera.nRNGDirect + wavelengthSource.nRNGSamples + response.nRNGSamples
        )
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=1,
                normalization=self.normalization,
                polarized=polarized,
            )
        )

    def collectStages(self) -> list[tuple[str, Component]]:
        return [
            ("photons", self.wavelengthSource),
            ("lightSource", self.source),
            ("camera", self.camera),
            ("tracer", self),
            ("callback", self.callback),
            ("response", self.response),
        ]

    def params(self):
        dev = self.device
        p = {
            "tracer": host_dict({"batchSize": (self.batchSize, np.int64), "maxTime": (self.maxTime, np.float32)}, dev),
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "camera": self.camera.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
        }
        if self.scene is not None:
            p["scene"] = self.scene.pack
            name = self.scene.medium
            p["medium"] = self.scene.materials.media.medium(name).to(dev) if name else None
        else:
            p["medium"] = None if self.medium is None else self.medium.to(dev)
        return p

    def _trace_batch(self, p, counter, streams):
        if self.scene is not None:
            pack = p["scene"]
            lo, hi = pack.lower_bbox, pack.upper_bbox
            occluder = lambda a, b: is_visible(pack, a, b)
        else:
            lo = torch.full((3,), -1.0 * u.km, dtype=torch.float32, device=streams.device)
            hi = -lo
            occluder = None
        extent = hi - lo
        prop = PropagateParams(
            scatter_coefficient=torch.full((), float("nan"), device=streams.device),
            lower_bbox=lo,
            upper_bbox=hi,
            max_time=p["tracer"]["maxTime"],
            max_dist=sqrt(dot(extent, extent)),
        )
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init(streams.device)
        cb_state = self.callback.init(streams.shape[0], 2, streams.device)
        resp_state, cb_state, rng = sample_direct(
            self, p, prop, p["medium"], resp_state, cb_state, rng, occluder=occluder
        )
        if self._debug_rng:
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state
