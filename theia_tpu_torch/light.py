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

from . import units as u
from .component import Component
from .material import MediumConstants
from .ops.math3d import dot, local_frame, normalize, sqrt, vec3
from .ops.sampling import TWO_PI, sample_unit_sphere
from .random import RNGState

__all__ = [
    "SourceRay",
    "WavelengthSource",
    "ConstWavelengthSource",
    "UniformWavelengthSource",
    "LightSource",
    "SphericalLightSource",
    "PencilLightSource",
    "ConeLightSource",
    "dw_dA",
]


def dw_dA(observer: torch.Tensor, target: torch.Tensor, normal: torch.Tensor | None):
    """Jacobian from an area to a solid-angle integral, dw = |cos| / r^2 dA
    (reference: lightsource.common.glsl:40-56). ``normal=None`` or the zero
    vector marks a volume point (cos = 1)."""
    direction = target - observer
    r2 = dot(direction, direction)
    if normal is None:
        return 1.0 / r2
    is_zero = dot(normal, normal) == 0.0
    cos_nrm = torch.where(is_zero, 1.0, torch.abs(dot(normalize(direction), normal)))
    return cos_nrm / r2


@dataclass(frozen=True)
class SourceRay:
    """Light-source sample (reference: shader/lightsource.common.glsl:11-46).
    ``stokes``/``pol_ref`` are None for unpolarized sources."""

    position: torch.Tensor  # f32[N,3]
    direction: torch.Tensor  # f32[N,3]
    start_time: torch.Tensor  # f32[N]
    contrib: torch.Tensor  # f32[N]
    stokes: torch.Tensor | None = None  # f32[N,4]
    pol_ref: torch.Tensor | None = None  # f32[N,3]


class WavelengthSource(Component):
    """Base class for wavelength samplers (reference: src/theia/light.py:58-78)."""

    name = "Wavelength Source"
    nRNGSamples: int = 0

    def sample(self, params, rng: RNGState) -> tuple[tuple, RNGState]:
        """Returns ((wavelength, contrib), advanced rng)."""
        raise NotImplementedError


class ConstWavelengthSource(WavelengthSource):
    """Monochromatic source (reference: src/theia/light.py:258-283)."""

    name = "Const Wavelength Source"
    nRNGSamples = 0
    _param_names = ("wavelength",)

    def __init__(self, wavelength: float = 600.0 * u.nm) -> None:
        self.wavelength = wavelength

    def sample(self, params, rng: RNGState):
        lam = torch.broadcast_to(params["wavelength"], rng.stream.shape)
        return (lam, torch.ones_like(lam)), rng


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
    nRNGBackward: int = 0

    def sample_forward(
        self, params, wavelength, constants: MediumConstants, rng: RNGState
    ) -> tuple[SourceRay, RNGState]:
        raise NotImplementedError

    def sample_backward(
        self, params, observer, normal, wavelength, constants: MediumConstants, rng: RNGState
    ) -> tuple[SourceRay, RNGState]:
        """A source point seen from ``observer`` (whose surface ``normal``
        is zero for a volume point) for a light connection."""
        raise NotImplementedError


def _start_time(params, u):
    t0, t1 = params["timeRange"][0], params["timeRange"][1]
    return t0 * (1.0 - u) + t1 * u


class SphericalLightSource(LightSource):
    """Isotropic unpolarized point source distributing ``budget`` photons/
    energy (reference: src/theia/light.py:1105-1180,
    shader/lightsource.spherical.glsl)."""

    name = "Spherical Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 3
    nRNGBackward = 1
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
        start = _start_time(params, v)
        pos = torch.broadcast_to(params["position"], direction.shape)
        contrib = torch.broadcast_to(params["_contribFwd"], start.shape)
        return SourceRay(pos, direction, start, contrib), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng: RNGState):
        pos = torch.broadcast_to(params["position"], observer.shape)
        direction = normalize(observer - pos)
        uu, rng = rng.uniform()
        contrib = params["_contribBwd"] * dw_dA(pos, observer, normal)
        return SourceRay(pos, direction, _start_time(params, uu), contrib), rng


class PencilLightSource(LightSource):
    """Delta beam, forward only (reference: src/theia/light.py:1024-1102,
    shader/lightsource.pencil.glsl). ``stokes``/``polarizationRef``: an
    optional constant polarization state."""

    name = "Pencil Light Source"
    supportForward = True
    nRNGForward = 1
    _param_names = ("position", "direction", "budget", "timeRange")
    _extra_names = ("stokes", "polarizationRef")

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        timeRange=(0.0, 100.0),
        budget: float = 1.0,
        stokes=None,
        polarizationRef=None,
    ) -> None:
        self.position = position
        self.direction = direction
        self.timeRange = timeRange
        self.budget = budget
        self.stokes = stokes
        self.polarizationRef = polarizationRef

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        uu, rng = rng.uniform()
        t0, t1 = params["timeRange"][0], params["timeRange"][1]
        start = t0 * (1.0 - uu) + t1 * uu
        pos = torch.broadcast_to(params["position"], (*start.shape, 3))
        direction = torch.broadcast_to(params["direction"], pos.shape)
        contrib = torch.broadcast_to(params["budget"], start.shape)
        stokes = pol_ref = None
        if self.stokes is not None:
            const = lambda v, n: torch.broadcast_to(
                torch.tensor(v, dtype=torch.float32, device=start.device), (*start.shape, n)
            )
            stokes, pol_ref = const(self.stokes, 4), const(self.polarizationRef, 3)
        return SourceRay(pos, direction, start, contrib, stokes, pol_ref), rng


class ConeLightSource(LightSource):
    """Point source emitting uniformly into a cone
    (reference: src/theia/light.py:883-1021, shader/lightsource.cone.glsl).
    ``stokes``/``polarizationRef``: an optional constant polarization
    state, its frame re-orthogonalized against each ray."""

    name = "Cone Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 3
    nRNGBackward = 1
    _param_names = ("position", "direction", "cosOpeningAngle", "timeRange", "_contribFwd", "_contribBwd")
    _extra_names = ("budget",)

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        cosOpeningAngle: float = 0.5,
        timeRange=(0.0, 100.0),
        budget: float = 1.0,
        stokes=None,
        polarizationRef=None,
    ) -> None:
        self.position = position
        self.direction = direction
        self.cosOpeningAngle = cosOpeningAngle
        self.timeRange = timeRange
        self.budget = budget
        self.stokes = stokes
        self.polarizationRef = polarizationRef
        self.update()

    def update(self) -> None:
        self._contribFwd = self.budget
        self._contribBwd = self.budget / (2.0 * np.pi * (1.0 - self.cosOpeningAngle))

    def params(self, device):
        self.update()
        return super().params(device)

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        (u1, u2), rng = rng.uniform2d()
        phi = TWO_PI * u1
        cos_theta = (1.0 - u2) + params["cosOpeningAngle"] * u2
        sin_theta = sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
        local = vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
        axis = normalize(torch.broadcast_to(params["direction"], (*phi.shape, 3)))
        vx, vy = local_frame(axis)
        direction = local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * axis
        v, rng = rng.uniform()
        start = _start_time(params, v)
        pos = torch.broadcast_to(params["position"], direction.shape)
        contrib = torch.broadcast_to(params["_contribFwd"], start.shape)
        stokes, pol_ref = self._pol(direction, start.shape)
        return SourceRay(pos, direction, start, contrib, stokes, pol_ref), rng

    def _pol(self, direction, shape):
        """Constant Stokes vector, its frame re-orthogonalized against
        each ray (reference: lightsource.cone.glsl:47-59)."""
        if self.stokes is None:
            return None, None
        const = lambda v, n: torch.broadcast_to(
            torch.tensor(v, dtype=torch.float32, device=direction.device), (*shape, n)
        )
        stokes, ref = const(self.stokes, 4), const(self.polarizationRef, 3)
        ref = ref - dot(ref, direction)[..., None] * direction
        return stokes, normalize(ref)

    def sample_backward(self, params, observer, normal, wavelength, constants, rng: RNGState):
        pos = torch.broadcast_to(params["position"], observer.shape)
        direction = normalize(observer - pos)
        cos_angle = dot(direction, torch.broadcast_to(params["direction"], pos.shape))
        inside = (cos_angle > params["cosOpeningAngle"]).to(torch.float32)
        contrib = params["_contribBwd"] * inside * dw_dA(pos, observer, normal)
        uu, rng = rng.uniform()
        start = _start_time(params, uu)
        stokes, pol_ref = self._pol(direction, start.shape)
        return SourceRay(pos, direction, start, contrib, stokes, pol_ref), rng
