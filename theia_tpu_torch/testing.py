"""Testing helpers (reference: src/theia/testing.py): the analytic water
model, and the standalone samplers of ``theia_tpu.testing``.

The samplers run a component's sampling function over a batch of lanes
(stream ids 0 .. n - 1, dim 0) on a device and return host arrays: the
analogue of the reference's queue-filling sampler stages. They draw
through the port's generators, so every lane draws the same numbers and
ends at the same RNG dim as in ``theia_tpu``. Lanes live on ``device``,
the card unless the caller names another."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera import Camera
from .component import map_tensors, resolve_device
from .light import LightSource, WavelengthSource
from .material import DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel, medium_constants
from .random import PhiloxRNG
from .target import Target, TargetGuide

__all__ = [
    "WaterTestModel",
    "LightSampler",
    "BackwardLightSampler",
    "CameraRaySampler",
    "CameraDirectSampler",
    "TargetSampler",
    "TargetGuideSampler",
    "sampleLight",
    "sampleBackwardLight",
    "sampleCameraRay",
    "sampleCameraPoint",
    "sampleTarget",
    "sampleTargetGuide",
    "sampleWavelength",
]


class WaterTestModel(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    """Simple analytic water-like model for tests
    (reference: src/theia/testing.py:641-656)."""

    ModelName = "water_test"

    def __init__(self, *, mu_a=0.01, mu_s=0.05, g=0.9) -> None:
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.36, mu_a=mu_a, mu_s=mu_s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


def _state(n: int, rng, device):
    rng = rng if rng is not None else PhiloxRNG(key=0xC0FFEE)
    return rng.state(torch.arange(n, dtype=torch.int32, device=device))


def _np(obj):
    """A sample (a dataclass of tensors, a tuple, a tensor) with every
    tensor copied to the host as a numpy array."""
    return map_tensors(lambda t: t.detach().cpu().numpy(), obj)


def _constants(medium, wavelength, n: int, device):
    lam = torch.full((n,), float(wavelength), dtype=torch.float32, device=device)
    return lam, medium_constants(None if medium is None else medium.to(device), lam)


def _rows(point, n: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(np.asarray(point, np.float32), device=device), (n, 3))


def sampleWavelength(source: WavelengthSource, n: int, *, rng=None, device="cuda"):
    """Sample n wavelengths: (wavelength, contrib) arrays
    (reference: theia.light.WavelengthSampler)."""
    device = resolve_device(device)
    (lam, contrib), _ = source.sample(source.params(device), _state(n, rng, device))
    return _np(lam), _np(torch.broadcast_to(contrib, lam.shape))


def sampleLight(source: LightSource, n: int, *, wavelength=450.0, medium=None, rng=None, device="cuda"):
    """Sample n forward light rays (reference: theia.light.LightSampler)."""
    device = resolve_device(device)
    lam, const = _constants(medium, wavelength, n, device)
    ray, _ = source.sample_forward(source.params(device), lam, const, _state(n, rng, device))
    return _np(ray)


def sampleBackwardLight(
    source: LightSource, observer, n: int, *, normal=None, wavelength=450.0, medium=None, rng=None, device="cuda",
):
    """Backward light samples toward an observer
    (reference: src/theia/testing.py BackwardLightSampler)."""
    device = resolve_device(device)
    lam, const = _constants(medium, wavelength, n, device)
    nrm = torch.zeros((n, 3), dtype=torch.float32, device=device) if normal is None else _rows(normal, n, device)
    ray, _ = source.sample_backward(
        source.params(device), _rows(observer, n, device), nrm, lam, const, _state(n, rng, device)
    )
    return _np(ray)


def sampleCameraRay(camera: Camera, n: int, *, wavelength=450.0, rng=None, device="cuda"):
    """Sample n camera rays (reference: theia.camera.CameraRaySampler)."""
    device = resolve_device(device)
    lam = torch.full((n,), float(wavelength), dtype=torch.float32, device=device)
    ray, _ = camera.sample_ray(camera.params(device), lam, _state(n, rng, device))
    return _np(ray)


def sampleCameraPoint(camera: Camera, n: int, *, wavelength=450.0, rng=None, device="cuda"):
    """Sample n camera points for direct lighting
    (reference: src/theia/testing.py CameraDirectSampler)."""
    device = resolve_device(device)
    lam = torch.full((n,), float(wavelength), dtype=torch.float32, device=device)
    pt, _ = camera.sample_point(camera.params(device), lam, _state(n, rng, device))
    return _np(pt)


def sampleTarget(target: Target, observer, n: int, *, rng=None, device="cuda"):
    """Sample target points from an observer
    (reference: src/theia/testing.py TargetSampler)."""
    device = resolve_device(device)
    smp, _ = target.sample(target.params(device), _rows(observer, n, device), _state(n, rng, device))
    return _np(smp)


def sampleTargetGuide(guide: TargetGuide, observer, n: int, *, rng=None, device="cuda"):
    """Sample guide directions (reference: src/theia/testing.py
    TargetGuideSampler)."""
    device = resolve_device(device)
    smp, _ = guide.sample(guide.params(device), _rows(observer, n, device), _state(n, rng, device))
    return _np(smp)


# ---------------------------------------------------------------------------
# reference-style sampler stages
# ---------------------------------------------------------------------------


def _as_result(obj) -> dict:
    """A sample's fields as a dict with the reference's camelCase keys
    (start_time -> startTime, pol_ref -> polRef, ...); None fields drop."""

    def camel(name: str) -> str:
        head, *rest = name.split("_")
        return head + "".join(w.capitalize() for w in rest)

    return {
        camel(f.name): np.asarray(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name) is not None
    }


class _Sampler:
    """Base of the reference-style sampler stages (reference:
    src/theia/testing.py / LightSampler / CameraRaySampler): construct
    with a component and a capacity, call :meth:`run` per batch; the RNG
    advances between batches as a pipeline stage's would."""

    #: draw budget reserved per item between batches
    _DRAWS_PER_ITEM = 64

    def __init__(self, capacity: int, rng=None, device="cuda") -> None:
        self.capacity = capacity
        self.rng = rng if rng is not None else PhiloxRNG(key=0xC0FFEE)
        self.device = resolve_device(device)

    def _advance(self):
        self.rng.advance(self._DRAWS_PER_ITEM)

    def run(self) -> dict:
        out = self._sample()
        self._advance()
        return out


class LightSampler(_Sampler):
    """Draws forward light samples (reference: theia.light.LightSampler);
    ``run()`` returns the dict of items.LightSampleItem's fields
    (PolarizedLightSampleItem's when the source emits polarized light)."""

    def __init__(self, source, capacity, *, wavelength=450.0, medium=None, rng=None, device="cuda"):
        super().__init__(capacity, rng, device)
        self.source = source
        self.wavelength = wavelength
        self.medium = medium

    def _sample(self):
        return _as_result(sampleLight(
            self.source, self.capacity, wavelength=self.wavelength, medium=self.medium, rng=self.rng,
            device=self.device,
        ))


class BackwardLightSampler(_Sampler):
    """Backward light samples toward an observer
    (reference: src/theia/testing.py BackwardLightSampler)."""

    def __init__(
        self, source, observer, capacity, *, normal=None, wavelength=450.0, medium=None, rng=None, device="cuda",
    ):
        super().__init__(capacity, rng, device)
        self.source = source
        self.observer = observer
        self.normal = normal
        self.wavelength = wavelength
        self.medium = medium

    def _sample(self):
        return _as_result(sampleBackwardLight(
            self.source, self.observer, self.capacity, normal=self.normal, wavelength=self.wavelength,
            medium=self.medium, rng=self.rng, device=self.device,
        ))


class CameraRaySampler(_Sampler):
    """Camera ray samples (reference: theia.camera.CameraRaySampler);
    the dict holds items.CameraRayItem's fields."""

    def __init__(self, camera, capacity, *, wavelength=450.0, rng=None, device="cuda"):
        super().__init__(capacity, rng, device)
        self.camera = camera
        self.wavelength = wavelength

    def _sample(self):
        return _as_result(sampleCameraRay(
            self.camera, self.capacity, wavelength=self.wavelength, rng=self.rng, device=self.device
        ))


class CameraDirectSampler(_Sampler):
    """Camera points for direct lighting
    (reference: src/theia/testing.py CameraDirectSampler)."""

    def __init__(self, camera, capacity, *, wavelength=450.0, rng=None, device="cuda"):
        super().__init__(capacity, rng, device)
        self.camera = camera
        self.wavelength = wavelength

    def _sample(self):
        return _as_result(sampleCameraPoint(
            self.camera, self.capacity, wavelength=self.wavelength, rng=self.rng, device=self.device
        ))


class TargetSampler(_Sampler):
    """Target samples from an observer
    (reference: src/theia/testing.py TargetSampler)."""

    def __init__(self, target, observer, capacity, *, rng=None, device="cuda"):
        super().__init__(capacity, rng, device)
        self.target = target
        self.observer = observer

    def _sample(self):
        return _as_result(sampleTarget(self.target, self.observer, self.capacity, rng=self.rng, device=self.device))


class TargetGuideSampler(_Sampler):
    """Guide-direction samples from an observer
    (reference: src/theia/testing.py TargetGuideSampler)."""

    def __init__(self, guide, observer, capacity, *, rng=None, device="cuda"):
        super().__init__(capacity, rng, device)
        self.guide = guide
        self.observer = observer

    def _sample(self):
        return _as_result(sampleTargetGuide(
            self.guide, self.observer, self.capacity, rng=self.rng, device=self.device
        ))
