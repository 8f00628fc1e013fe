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
from .component import Component, host_dict
from .material import MediumConstants
from .ops.math3d import cross, distance, dot, local_frame, normalize, sqrt, vec3
from .ops.sampling import TWO_PI, sample_unit_disk, sample_unit_sphere, spherical_to_cartesian
from .random import RNGState

__all__ = [
    "LightSampler",
    "WavelengthSampleItem",
    "LightSampleItem",
    "PolarizedLightSampleItem",
    "SourceRay",
    "WavelengthSource",
    "ConstWavelengthSource",
    "UniformWavelengthSource",
    "FunctionWavelengthSource",
    "HostWavelengthSource",
    "StreamingHostWavelengthSource",
    "LightSource",
    "SphericalLightSource",
    "PencilLightSource",
    "ConeLightSource",
    "HostLightSource",
    "StreamingHostLightSource",
    "CherenkovLightSource",
    "ParticleTrack",
    "CherenkovTrackLightSource",
    "MuonTrackLightSource",
    "ParticleCascadeLightSource",
    "frankTamm",
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


# ---------------------------------------------------------------------------
# host-provided and tabulated samples
# ---------------------------------------------------------------------------


def _stream_rows(params, key: str, rng: RNGState):
    """Each lane's row of the host arrays: its stream id modulo the rows."""
    idx = torch.remainder(rng.stream, params[key].shape[0])
    return lambda name: torch.index_select(params[name], 0, idx)


class HostWavelengthSource(WavelengthSource):
    """Samples provided by the host as arrays indexed by the lane's stream id
    (reference: src/theia/light.py:87-257)."""

    name = "Host Wavelength Source"
    nRNGSamples = 0
    _param_names = ("wavelength", "contrib")

    def __init__(self, wavelength, contrib=None) -> None:
        self.wavelength = np.asarray(wavelength, np.float32)
        self.contrib = np.ones_like(self.wavelength) if contrib is None else np.asarray(contrib, np.float32)

    def sample(self, params, rng: RNGState):
        rows = _stream_rows(params, "wavelength", rng)
        return (rows("wavelength"), rows("contrib")), rng


class StreamingHostWavelengthSource(HostWavelengthSource):
    """Walks a large host array batch by batch: each :meth:`params` takes
    the next ``batchSize`` rows (reference: src/theia/light.py:180-257)."""

    name = "Streaming Host Wavelength Source"

    def __init__(self, wavelength, contrib=None, *, batchSize: int) -> None:
        self._all_wavelength = np.asarray(wavelength, np.float32)
        self._all_contrib = (
            np.ones_like(self._all_wavelength) if contrib is None else np.asarray(contrib, np.float32)
        )
        self.batchSize = batchSize
        self.offset = 0
        self._slice()

    def _slice(self) -> None:
        idx = (self.offset + np.arange(self.batchSize)) % len(self._all_wavelength)
        self.wavelength = self._all_wavelength[idx]
        self.contrib = self._all_contrib[idx]

    def update(self) -> None:
        self._slice()
        self.offset = (self.offset + self.batchSize) % len(self._all_wavelength)

    def params(self, device):
        self.update()
        return super().params(device)


class HostLightSource(LightSource):
    """Source rays provided by the host as arrays indexed by stream id
    (reference: src/theia/light.py:692-881)."""

    name = "Host Light Source"
    supportForward = True
    nRNGForward = 0
    _param_names = ("position", "direction", "startTime", "contrib")

    def __init__(self, position, direction, startTime, contrib) -> None:
        self.position = np.asarray(position, np.float32)
        self.direction = np.asarray(direction, np.float32)
        self.startTime = np.asarray(startTime, np.float32)
        self.contrib = np.asarray(contrib, np.float32)

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        rows = _stream_rows(params, "startTime", rng)
        return SourceRay(rows("position"), rows("direction"), rows("startTime"), rows("contrib")), rng


class StreamingHostLightSource(HostLightSource):
    """Streams source rays from large host arrays batch by batch
    (reference: src/theia/light.py:789-881)."""

    name = "Streaming Host Light Source"

    def __init__(self, position, direction, startTime, contrib, *, batchSize: int):
        self._all = dict(
            position=np.asarray(position, np.float32),
            direction=np.asarray(direction, np.float32),
            startTime=np.asarray(startTime, np.float32),
            contrib=np.asarray(contrib, np.float32),
        )
        self.batchSize = batchSize
        self.offset = 0
        self._slice()

    def _slice(self) -> None:
        idx = (self.offset + np.arange(self.batchSize)) % len(self._all["startTime"])
        for key, rows in self._all.items():
            setattr(self, key, rows[idx])

    def update(self) -> None:
        self._slice()
        self.offset = (self.offset + self.batchSize) % len(self._all["startTime"])

    def params(self, device):
        self.update()
        return super().params(device)


class FunctionWavelengthSource(WavelengthSource):
    """Importance samples a user distribution over wavelength through a
    numerically inverted CDF table, read by ``lookup`` (on the card the
    table-read kernel) (reference: src/theia/light.py:351-414,
    shader/wavelengthsource.function.glsl)."""

    name = "Function Wavelength Source"
    nRNGSamples = 1
    _param_names = ("_table", "_contrib")

    def __init__(self, fn, *, lambdaRange=(300.0, 700.0), numSamples: int = 1024):
        from scipy.integrate import quad
        from scipy.stats.sampling import NumericalInversePolynomial

        contrib, _ = quad(fn, *lambdaRange)

        class Dist:
            def pdf(self, x):
                return fn(x)

        inv_cdf = NumericalInversePolynomial(Dist(), domain=lambdaRange)
        self._table = inv_cdf.ppf(np.linspace(0.0, 1.0, numSamples)).astype(np.float32)
        self._contrib = float(contrib)

    def sample(self, params, rng: RNGState):
        from .lookup import lookup

        uu, rng = rng.uniform()
        lam = lookup(params["_table"], uu)
        return (lam, torch.broadcast_to(params["_contrib"], lam.shape)), rng


# ---------------------------------------------------------------------------
# Cherenkov / particle light sources
# ---------------------------------------------------------------------------

#: fine structure constant
_ALPHA = 7.2973525693e-3
#: the Frank-Tamm prefactors in photon count (2 pi alpha, lambda in um) and
#: in energy (eV/(m nm), radial), as 0-d CPU tensors: a tensor op with one
#: on the left is one true division on any device
_FT_PHOTONS = torch.tensor(2.0 * np.pi * 7.2973525693, dtype=torch.float32)
_FT_ENERGY = torch.tensor(9.04756408986352, dtype=torch.float32)


def frankTamm(wavelength, refractiveIndex, beta: float = 1.0):
    """Frank-Tamm photon yield d^2N/(dx dlam) in [1/m 1/nm], on the host
    (reference: src/theia/light.py:1667-1687)."""
    lam = np.asarray(wavelength) / u.nm
    n = beta * np.asarray(refractiveIndex)
    return 2.0 * np.pi * _ALPHA / lam**2 * (1.0 - 1.0 / n**2) * 1e9


def _frank_tamm_photons(n, lam):
    """Frank-Tamm in photon count a lane
    (reference: shader/lightsource.particles.common.glsl:52-62)."""
    lam_um = lam * 1e-3
    res = torch.div(_FT_PHOTONS, lam_um * lam_um) * (1.0 - 1.0 / (n * n))
    return torch.clamp_min(res, 0.0)


def _frank_tamm_energy(n, lam):
    """Frank-Tamm in eV/(m nm), radial, a lane
    (reference: shader/lightsource.cherenkov.common.glsl:6-23)."""
    lam_um = lam * 1e-3
    res = torch.div(_FT_ENERGY, lam_um * lam_um * lam_um) * (1.0 - 1.0 / (n * n))
    return torch.clamp_min(res, 0.0)


def _ft_factor(photons: bool, n, lam):
    """The Cherenkov sources' Frank-Tamm factor: photon count over 2 pi,
    or energy."""
    return _frank_tamm_photons(n, lam) / TWO_PI if photons else _frank_tamm_energy(n, lam)


def _rotate_to(axis, local):
    vx, vy = local_frame(axis)
    return local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * axis


def _cherenkov_angle(n):
    """(cos, sin) of the Cherenkov angle at beta = 1."""
    cos_theta = 1.0 / n
    return cos_theta, sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))


def _linear_stokes(shape, device) -> torch.Tensor:
    """(1, 1, 0, 0) a lane: light linearly polarized along its reference."""
    stokes = torch.zeros((*shape, 4), dtype=torch.float32, device=device)
    stokes[..., :2] = 1.0
    return stokes


class CherenkovLightSource(LightSource):
    """Cherenkov light from a straight particle track at beta = 1
    (reference: src/theia/light.py:1183-1271,
    shader/lightsource.cherenkov.simple.glsl)."""

    name = "Cherenkov Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 2
    nRNGBackward = 0
    _param_names = ("trackStart", "trackEnd", "startTime", "endTime")
    _extra_names = ("usePhotonCount",)

    def __init__(
        self,
        *,
        trackStart=(0.0, 0.0, 0.0),
        trackEnd=(100.0, 0.0, 0.0),
        startTime: float = 0.0,
        endTime: float = 100.0 / u.c,
        usePhotonCount: bool = False,
    ) -> None:
        self.trackStart = trackStart
        self.trackEnd = trackEnd
        self.startTime = startTime
        self.endTime = endTime
        self.usePhotonCount = usePhotonCount

    def _track(self, params, shape):
        start = torch.broadcast_to(params["trackStart"], (*shape, 3))
        end = torch.broadcast_to(params["trackEnd"], (*shape, 3))
        d = end - start
        dist = sqrt(torch.clamp_min(dot(d, d), 1e-30))
        return start, end, d / dist[..., None], dist

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        shape = rng.stream.shape
        start, end, track_dir, track_dist = self._track(params, shape)
        uu, rng = rng.uniform()
        position = start * (1.0 - uu[..., None]) + end * uu[..., None]
        start_time = params["startTime"] * (1.0 - uu) + params["endTime"] * uu
        contrib = TWO_PI * _ft_factor(self.usePhotonCount, constants.n, wavelength) * track_dist
        cos_theta, sin_theta = _cherenkov_angle(constants.n)
        phi, rng = rng.uniform()
        phi = TWO_PI * phi
        local = vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
        ray_dir = _rotate_to(track_dir, local)
        pol_ref = normalize(cross(ray_dir, track_dir))
        stokes = _linear_stokes(shape, position.device)
        return SourceRay(position, ray_dir, start_time, contrib, stokes, pol_ref), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng: RNGState):
        shape = observer.shape[:-1]
        start, _, track_dir, track_dist = self._track(params, shape)
        cos_theta, sin_theta = _cherenkov_angle(constants.n)
        mu = dot(observer - start, track_dir)
        d = distance(observer, start + mu[..., None] * track_dir)
        mu = mu - cos_theta / torch.clamp_min(sin_theta, 1e-7) * d
        position = start + mu[..., None] * track_dir
        ray_dir = normalize(observer - position)
        uu = mu / track_dist
        start_time = params["startTime"] * (1.0 - uu) + params["endTime"] * uu
        contrib = _ft_factor(self.usePhotonCount, constants.n, wavelength)
        is_zero = dot(normal, normal) == 0.0
        cos_nrm = torch.clamp_min(torch.where(is_zero, 1.0, dot(ray_dir, normal)), 0.0)
        contrib = contrib * cos_nrm / torch.clamp_min(d, 1e-30)
        contrib = contrib * ((mu >= 0.0) & (mu <= track_dist)).to(torch.float32)
        pol_ref = normalize(cross(ray_dir, track_dir))
        stokes = _linear_stokes(shape, position.device)
        return SourceRay(position, ray_dir, start_time, contrib, stokes, pol_ref), rng


class ParticleTrack:
    """Particle track as a (L, 4) [x, y, z, t] vertex array
    (reference: src/theia/light.py:1274-1352: there a device tensor and a
    length header; here a host array that the source's params copy)."""

    def __init__(self, vertices) -> None:
        self.vertices = np.asarray(vertices, np.float32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 4:
            raise ValueError("track vertices must have shape (L, 4)")

    def setVertices(self, vertices) -> None:
        self.vertices = np.asarray(vertices, np.float32)

    @property
    def length(self) -> int:
        return len(self.vertices)


class CherenkovTrackLightSource(LightSource):
    """Cherenkov light from an arbitrary particle track at beta = 1
    (reference: src/theia/light.py:1355-1410,
    shader/lightsource.cherenkov.track.glsl). Its backward mode is
    ``theia_tpu``'s (the reference leaves it a TODO,
    lightsource.cherenkov.track.glsl:78-79): one candidate a segment, one
    drawn in proportion to its contribution, the lane carrying their sum;
    on the card the kernel of ``csrc/cherenkov_track.cu``
    (:func:`~theia_tpu_torch.ops.cherenkov_track.track_backward_sample`)."""

    name = "Cherenkov Track Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 2
    nRNGBackward = 1
    _param_names = ("track",)
    _extra_names = ("usePhotonCount",)

    def __init__(self, track: ParticleTrack | None = None, *, usePhotonCount: bool = False):
        self.track = track
        self.usePhotonCount = usePhotonCount

    def params(self, device):
        return host_dict({"track": (self.track.vertices, None)}, device)

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        track = params["track"]  # (L, 4)
        n_seg = track.shape[0] - 1
        uu, rng = rng.uniform()
        uu = uu * n_seg
        seg = torch.clamp_max(torch.floor(uu).to(torch.int64), n_seg - 1)
        frac = uu - torch.floor(uu)
        v0, v1 = track[seg], track[seg + 1]
        pos = v0[..., :3] * (1.0 - frac[..., None]) + v1[..., :3] * frac[..., None]
        time = v0[..., 3] * (1.0 - frac) + v1[..., 3] * frac
        cos_theta, sin_theta = _cherenkov_angle(constants.n)
        phi, rng = rng.uniform()
        phi = TWO_PI * phi
        local = vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
        seg_vec = v1[..., :3] - v0[..., :3]
        seg_len = sqrt(torch.clamp_min(dot(seg_vec, seg_vec), 1e-30))
        particle_dir = seg_vec / seg_len[..., None]
        ray_dir = _rotate_to(particle_dir, local)
        # float32(2 pi) * n_seg in float32, as theia_tpu's weakly typed product
        per_track = float(np.float32(TWO_PI) * np.float32(n_seg))
        contrib = per_track * seg_len * _ft_factor(self.usePhotonCount, constants.n, wavelength)
        pol_ref = normalize(cross(ray_dir, particle_dir))
        return SourceRay(pos, ray_dir, time, contrib, _linear_stokes(time.shape, pos.device), pol_ref), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng: RNGState):
        """Each straight segment has at most one point whose Cherenkov cone
        passes through ``observer``; one of them is drawn in proportion to
        its contribution and the lane carries the sum over the segments."""
        from .ops.cherenkov_track import segment_table, track_backward_sample

        seg = segment_table(params["track"])
        cos_theta, sin_theta = _cherenkov_angle(constants.n)
        cot = cos_theta / torch.clamp_min(sin_theta, 1e-7)
        ft = _ft_factor(self.usePhotonCount, constants.n, wavelength)
        uu, rng = rng.uniform()
        total, pos, ray_dir, time, k = track_backward_sample(
            seg, observer.contiguous(), normal.contiguous(), ft.contiguous(), cot.contiguous(), uu
        )
        pol_ref = normalize(cross(ray_dir, seg[k, 5:8]))
        return SourceRay(pos, ray_dir, time, total, _linear_stokes(total.shape, pos.device), pol_ref), rng


def _sample_emission_angle(n, a, b, uu):
    """Sample the angular emission profile around the Cherenkov angle
    (reference: shader/lightsource.particles.common.glsl:72-100)."""
    cos_chev = 1.0 / n
    int_lower = 1.0 - torch.exp(-b * torch.pow(1.0 - cos_chev, a))
    int_upper = 1.0 - torch.exp(-b * torch.pow(1.0 + cos_chev, a))
    uu = uu * (int_upper + int_lower) - int_lower
    x = torch.pow(-torch.log1p(-torch.abs(uu)) / b, 1.0 / a)
    return cos_chev - torch.sign(uu) * x


def _eval_emission_angle(n, a, b, cos_theta):
    """Evaluate the angular emission pdf
    (reference: shader/lightsource.particles.common.glsl:143-158)."""
    cos_chev = 1.0 / n
    norm = a * b
    norm = norm / (2.0 - torch.exp(-b * torch.pow(1.0 - cos_chev, a)) - torch.exp(-b * torch.pow(1.0 + cos_chev, a)))
    x = torch.clamp_min(torch.abs(cos_theta - cos_chev), 1e-7)
    return torch.exp(-b * torch.pow(x, a)) * torch.pow(x, a - 1.0) * norm


#: log(2) and the proxy shape's 2.2, as 0-d CPU tensors (true divisions)
_LN2 = torch.tensor(np.log(2.0), dtype=torch.float32)
_TWO_POINT_TWO = torch.tensor(2.2, dtype=torch.float32)


class MuonTrackLightSource(LightSource):
    """Cherenkov light from a muon track plus its secondaries (< 500 MeV)
    after Raedel's parameterization (reference: src/theia/light.py:1413-1520,
    shader/lightsource.particles.muon.glsl)."""

    name = "Muon Track Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 3
    nRNGBackward = 1
    _param_names = (
        "startPosition", "startTime", "endPosition", "endTime", "_energyScale", "_a_angular", "_b_angular",
    )
    _extra_names = ("muonEnergy", "applyFrankTamm")

    def __init__(
        self,
        startPosition=(0.0, 0.0, 0.0),
        startTime: float = 0.0,
        endPosition=(0.0, 0.0, 0.0),
        endTime: float = 0.0,
        muonEnergy: float = 1.0 * u.GeV,
        applyFrankTamm: bool = True,
    ) -> None:
        self.startPosition = startPosition
        self.startTime = startTime
        self.endPosition = endPosition
        self.endTime = endTime
        self.applyFrankTamm = applyFrankTamm
        self.muonEnergy = muonEnergy

    @property
    def muonEnergy(self) -> float:
        return self._muonEnergy

    @muonEnergy.setter
    def muonEnergy(self, value: float) -> None:
        self._muonEnergy = value
        # secondary-particle light yield and angular fit
        # (reference: src/theia/light.py:1506-1516, notebooks/track_angular_dist_fit.ipynb)
        self._energyScale = 1.1880 + 0.0206 * np.log(value)
        self._a_angular = 0.86634 - 7.5624e-3 * np.log10(value)
        self._b_angular = 2.5030 + 3.0533e-2 * np.log10(value)

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        shape = rng.stream.shape
        start = torch.broadcast_to(params["startPosition"], (*shape, 3))
        end = torch.broadcast_to(params["endPosition"], (*shape, 3))
        uu, rng = rng.uniform()
        position = start * (1.0 - uu[..., None]) + end * uu[..., None]
        start_time = params["startTime"] * (1.0 - uu) + params["endTime"] * uu
        d = end - start
        track_dist = sqrt(torch.clamp_min(dot(d, d), 1e-30))
        contrib = track_dist * params["_energyScale"]
        (v1, v2), rng = rng.uniform2d()
        phi = TWO_PI * v1
        cos_theta = _sample_emission_angle(constants.n, params["_a_angular"], params["_b_angular"], v2)
        ray_dir = _rotate_to(d / track_dist[..., None], spherical_to_cartesian(phi, cos_theta))
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        return SourceRay(position, ray_dir, start_time, contrib), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng: RNGState):
        """Importance samples the track point seen from ``observer`` from
        the proxy pdf 1/(d^2 + (a x)^2) around the closest point C of the
        track's line (x the signed distance from C, d the observer's
        distance to the line), whose inverse CDF is a tangent; a^2 =
        2.2/(b(b + 2)), b = ln2/(mu_e d) fits the proxy to the attenuation
        (the reference's scheme, shader/lightsource.particles.muon.glsl).
        The emission time interpolates startTime..endTime by the track
        fraction, as the forward branch does (the reference takes
        startTime + x/c here, glsl:111; both agree for a muon at c)."""
        start = torch.broadcast_to(params["startPosition"], observer.shape)
        end = torch.broadcast_to(params["endPosition"], observer.shape)
        seg = end - start
        track_dist = sqrt(torch.clamp_min(dot(seg, seg), 1e-30))
        track_dir = seg / track_dist[..., None]
        to_obs = observer - start
        start_dist = sqrt(torch.clamp_min(dot(to_obs, to_obs), 1e-30))
        cos_start = dot(to_obs / start_dist[..., None], track_dir)
        # signed distances along the track from the closest point C
        dist_start2c = -cos_start * start_dist
        dist_end2c = track_dist + dist_start2c
        d = sqrt(torch.clamp_min(1.0 - cos_start * cos_start, 0.0)) * start_dist
        d = torch.clamp_min(d, 1e-4)  # the observer on the track's line
        b = torch.div(_LN2, d * torch.clamp_min(constants.mu_e, 1e-6))
        a2 = torch.div(_TWO_POINT_TWO, b * (b + 2.0))
        a = sqrt(a2)
        # the proxy CDF's normalization; its 1/(a d) cancels in the inverse
        # CDF and comes back in the contribution
        int_lo = torch.atan(a * dist_start2c / d)
        int_hi = torch.atan(a * dist_end2c / d)
        norm = int_hi - int_lo
        uu, rng = rng.uniform()
        uu = uu * norm + int_lo
        x = d / a * torch.tan(uu)
        contrib = norm / (a * d) * (d * d + a2 * x * x)
        x = x - dist_start2c  # x = 0: the ray starts at startPosition
        ray_pos = start + x[..., None] * track_dir
        ray_dir = normalize(observer - ray_pos)
        frac = x / track_dist
        time = params["startTime"] * (1.0 - frac) + params["endTime"] * frac
        contrib = contrib * dw_dA(ray_pos, observer, normal)
        cos_obs = dot(track_dir, ray_dir)
        contrib = contrib * _eval_emission_angle(constants.n, params["_a_angular"], params["_b_angular"], cos_obs)
        contrib = contrib * params["_energyScale"]
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        # 1/2pi: the Frank-Tamm formula above misses the d/d(phi) factor
        return SourceRay(ray_pos, ray_dir, time, contrib / TWO_PI), rng


class ParticleCascadeLightSource(LightSource):
    """Cherenkov light from EM and hadronic showers (Raedel's
    parameterization): a gamma-distributed longitudinal profile and an
    angular emission fit (reference: src/theia/light.py:1522-1664,
    shader/lightsource.particles.cascade.glsl). Both directions draw the
    depth with :func:`~theia_tpu_torch.ops.gamma.sample_gamma`, whose
    draws a lane take 1 + 2 R dims (R the call's rounds, on the card taken
    by the kernel of ``csrc/gamma.cu``)."""

    name = "Particle Cascade Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 12  # gamma rejection: the draw count is a loose upper bound
    nRNGBackward = 10
    _param_names = (
        "startPosition", "startTime", "direction", "effectiveLength", "a_angular", "b_angular", "a_long", "b_long",
    )
    _extra_names = ("applyFrankTamm",)

    def __init__(
        self,
        startPosition=(0.0, 0.0, 0.0),
        startTime: float = 0.0,
        direction=(0.0, 0.0, 1.0),
        effectiveLength: float = 1.0,
        a_angular: float = 0.0,
        b_angular: float = 0.0,
        a_long: float = 0.0,
        b_long: float = 0.0,
        applyFrankTamm: bool = True,
    ) -> None:
        self.startPosition = startPosition
        self.startTime = startTime
        self.direction = direction
        self.effectiveLength = effectiveLength
        self.a_angular = a_angular
        self.b_angular = b_angular
        self.a_long = a_long
        self.b_long = b_long
        self.applyFrankTamm = applyFrankTamm

    def _vertex(self, params, shape, rng):
        """The shower's emission point: depth z ~ b_long Gamma(a_long),
        detached, on the axis; returns (axis, position, time, rng)."""
        from .ops.gamma import sample_gamma

        z, rng = sample_gamma(params["a_long"], rng)
        z = z.detach() * params["b_long"]
        axis = normalize(torch.broadcast_to(params["direction"], (*shape, 3)))
        pos = torch.broadcast_to(params["startPosition"], (*shape, 3)) + z[..., None] * axis
        return axis, pos, params["startTime"] + z / u.c, rng

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        axis, pos, time, rng = self._vertex(params, rng.stream.shape, rng)
        (u1, u2), rng = rng.uniform2d()
        cos_theta = _sample_emission_angle(constants.n, params["a_angular"], params["b_angular"], u2)
        ray_dir = _rotate_to(axis, spherical_to_cartesian(TWO_PI * u1, cos_theta))
        contrib = torch.broadcast_to(params["effectiveLength"], time.shape)
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        return SourceRay(pos, ray_dir, time, contrib), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng: RNGState):
        axis, pos, time, rng = self._vertex(params, observer.shape[:-1], rng)
        ray_dir = normalize(observer - pos)
        contrib = _eval_emission_angle(constants.n, params["a_angular"], params["b_angular"], dot(axis, ray_dir))
        contrib = contrib * (1.0 / (2.0 * np.pi))
        contrib = contrib * dw_dA(pos, observer, normal)
        contrib = contrib * params["effectiveLength"]
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        return SourceRay(pos, ray_dir, time, contrib), rng


from .items import LightSampleItem, PolarizedLightSampleItem, WavelengthSampleItem  # noqa: E402


def __getattr__(name):
    # the sampler lives in theia_tpu_torch.testing, which imports this
    # module; resolved lazily as theia_tpu.light resolves it
    if name == "LightSampler":
        from .testing import LightSampler

        return LightSampler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
