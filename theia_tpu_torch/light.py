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
from .ops.sampling import TWO_PI, sample_unit_disk, sample_unit_sphere
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
    "LightSourceTarget",
    "PointLightSourceTarget",
    "DiskLightSourceTarget",
    "FlatLightSourceTarget",
    "TargetLightSource",
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


# ---------------------------------------------------------------------------
# light-source targets: focus a backward-capable source on sampled points
# (reference: src/theia/target.py:738-1106, shader/lightsource.target.*.glsl,
# shader/lightsource.guided.glsl)
# ---------------------------------------------------------------------------


class LightSourceTarget(Component):
    """Samples the target points that focus a light source
    (``sampleLightTarget``)."""

    name = "Light Source Target"
    nRNGSamples: int = 0

    def sample(self, params, wavelength, rng: RNGState):
        """Returns ((position, normal, contrib), rng)."""
        raise NotImplementedError


class PointLightSourceTarget(LightSourceTarget):
    """A single point with a volume (zero) normal
    (reference: shader/lightsource.target.point.glsl)."""

    name = "Point Light Source Target"
    nRNGSamples = 0
    _param_names = ("position",)

    def __init__(self, *, position=(0.0, 0.0, 0.0)) -> None:
        self.position = position

    def sample(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        pos = torch.broadcast_to(params["position"], (*shape, 3))
        return (pos, torch.zeros_like(pos), torch.ones(shape, dtype=torch.float32, device=pos.device)), rng


class _PlanarLightSourceTarget(LightSourceTarget):
    """A point on a plane through ``position`` with normal ``normal``,
    drawn in the plane's own frame; its contribution is the area."""

    nRNGSamples = 2
    _extra_names = ("normal", "up")

    def update(self) -> None:
        from .target import _orient_frame

        m = _orient_frame(self.normal, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._area = self._area_of()

    def params(self, device):
        self.update()
        return super().params(device)

    def _frame(self, params, shape):
        o2w = torch.broadcast_to(params["_objToWorld"], (*shape, 3, 3))
        pos = torch.broadcast_to(params["position"], (*shape, 3))
        nrm = torch.broadcast_to(params["_normal"], (*shape, 3))
        return o2w, pos, nrm

    def sample(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        o2w, offset, nrm = self._frame(params, shape)
        local, rng = self._sample_local(params, rng)
        pos = (o2w @ local[..., None])[..., 0] + offset
        return (pos, nrm, torch.broadcast_to(params["_area"], shape)), rng


class DiskLightSourceTarget(_PlanarLightSourceTarget):
    """Disk target (reference: src/theia/target.py:770-868)."""

    name = "Disk Light Source Target"
    _param_names = ("radius", "position", "_normal", "_area", "_objToWorld")

    def __init__(self, *, position=(0.0, 0.0, 0.0), radius=1.0, normal=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0)) -> None:
        self.position = position
        self.radius = radius
        self.normal = normal
        self.up = up
        self.update()

    def _area_of(self) -> float:
        return np.pi * self.radius**2

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        return params["radius"] * sample_unit_disk(u1, u2), rng


class FlatLightSourceTarget(_PlanarLightSourceTarget):
    """Rectangular target (reference: src/theia/target.py:869-1004)."""

    name = "Flat Light Source Target"
    _param_names = ("width", "height", "position", "_normal", "_area", "_objToWorld")

    def __init__(
        self, *, width=1.0, height=1.0, position=(0.0, 0.0, 0.0), normal=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0)
    ) -> None:
        self.width = width
        self.height = height
        self.position = position
        self.normal = normal
        self.up = up
        self.update()

    def _area_of(self) -> float:
        return self.width * self.height

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        return vec3(params["width"] * (u1 - 0.5), params["height"] * (u2 - 0.5), torch.zeros_like(u1)), rng


class TargetLightSource(LightSource):
    """A backward-capable source focused on a target: a target point is
    sampled, then the principal source toward it
    (reference: src/theia/target.py:1006-1106, shader/lightsource.guided.glsl)."""

    name = "Target Light Source"
    supportForward = True
    supportBackward = False

    def __init__(self, source: LightSource, target: LightSourceTarget) -> None:
        if not source.supportBackward:
            raise ValueError("principal source must support backward mode")
        self.source = source
        self.target = target
        self.nRNGForward = target.nRNGSamples + source.nRNGBackward

    def params(self, device):
        return {"principal": self.source.params(device), "target": self.target.params(device)}

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        (pos, nrm, contrib), rng = self.target.sample(params["target"], wavelength, rng)
        ray, rng = self.source.sample_backward(params["principal"], pos, nrm, wavelength, constants, rng)
        return SourceRay(
            ray.position, ray.direction, ray.start_time, ray.contrib * contrib, ray.stokes, ray.pol_ref
        ), rng
