"""Wavelength and light sources.

Each source contributes a sampling function consuming the per-lane
:class:`~theia_tpu_torch.random.RNGState`; draw counts (``nRNG*``) match
``theia_tpu.light`` and the reference, so identical Philox streams give
identical samples (reference: src/theia/light.py, shader/lightsource.*.glsl,
shader/wavelengthsource.*.glsl).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .component import Component
from .material import MediumConstants
from .ops.sampling import sample_unit_sphere
from .random import RNGState

__all__ = [
    "SourceRay",
    "WavelengthSource",
    "UniformWavelengthSource",
    "LightSource",
    "SphericalLightSource",
]


@dataclass(frozen=True)
class SourceRay:
    """Light-source sample (reference: shader/lightsource.common.glsl:11-46)."""

    position: torch.Tensor  # f32[N,3]
    direction: torch.Tensor  # f32[N,3]
    start_time: torch.Tensor  # f32[N]
    contrib: torch.Tensor  # f32[N]


class WavelengthSource(Component):
    """Base class for wavelength samplers (reference: src/theia/light.py:58-78)."""

    name = "Wavelength Source"
    nRNGSamples: int = 0

    def sample(self, params, rng: RNGState) -> tuple[tuple, RNGState]:
        """Returns ((wavelength, contrib), advanced rng)."""
        raise NotImplementedError


class UniformWavelengthSource(WavelengthSource):
    """Uniform wavelength in [lam_min, lam_max]; contribution 1 when
    normalized else the range width (reference: src/theia/light.py:286-348,
    shader/wavelengthsource.uniform.glsl)."""

    name = "Uniform Wavelength Source"
    nRNGSamples = 1
    _param_names = ("lambdaRange", "_contrib")
    _extra_names = ("normalize",)

    def __init__(
        self,
        *,
        lambdaRange: tuple[float, float] = (300.0, 700.0),
        normalize: bool = True,
    ) -> None:
        self.lambdaRange = lambdaRange
        self.normalize = normalize
        self._contrib = 1.0

    def update(self) -> None:
        lr = self.lambdaRange[1] - self.lambdaRange[0]
        self._contrib = abs(lr) if (lr != 0.0 and not self.normalize) else 1.0

    def params(self, device):
        self.update()
        return super().params(device)

    def sample(self, params, rng: RNGState):
        uu, rng = rng.uniform()
        lo, hi = params["lambdaRange"][0], params["lambdaRange"][1]
        lam = lo * (1.0 - uu) + hi * uu
        return (lam, torch.broadcast_to(params["_contrib"], lam.shape)), rng


class LightSource(Component):
    """Base class for light sources (reference: src/theia/light.py:417-460)."""

    name = "Light Source"
    supportForward: bool = False
    supportBackward: bool = False
    nRNGForward: int = 0

    def sample_forward(
        self, params, wavelength, constants: MediumConstants, rng: RNGState
    ) -> tuple[SourceRay, RNGState]:
        raise NotImplementedError


class SphericalLightSource(LightSource):
    """Isotropic unpolarized point source distributing ``budget`` photons/
    energy (reference: src/theia/light.py:1105-1180,
    shader/lightsource.spherical.glsl). Forward sampling only so far."""

    name = "Spherical Light Source"
    supportForward = True
    nRNGForward = 3
    _param_names = ("position", "timeRange", "_contribFwd", "_contribBwd")
    _extra_names = ("budget",)

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        timeRange=(0.0, 100.0),
        budget: float = 1.0,
    ) -> None:
        self.position = position
        self.timeRange = timeRange
        self.budget = budget
        self.update()

    def update(self) -> None:
        self._contribFwd = self.budget
        # forward: the 4pi parameter volume cancels with the sampling prob
        self._contribBwd = self.budget / (4.0 * np.pi)

    def params(self, device):
        self.update()
        return super().params(device)

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        (u1, u2), rng = rng.uniform2d()
        direction = sample_unit_sphere(u1, u2)
        v, rng = rng.uniform()
        t0, t1 = params["timeRange"][0], params["timeRange"][1]
        start = t0 * (1.0 - v) + t1 * v
        pos = torch.broadcast_to(params["position"], direction.shape)
        contrib = torch.broadcast_to(params["_contribFwd"], start.shape)
        return SourceRay(pos, direction, start, contrib), rng
