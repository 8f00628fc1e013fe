"""Targets and target guides, as in ``theia_tpu.target``.

A target is an analytic detector proxy for volume tracing with three
functions on a wavefront of observers: ``sample`` (next-event
estimation), ``intersect`` and ``occluded``, returning a
:class:`TargetSample` whose lanes carry a ``valid`` mask (reference:
src/theia/target.py:37-424, shader/target.*.glsl). A target guide steers
a scene tracer's shadow rays toward a detector (reference:
src/theia/target.py:427-736, shader/target_guide.*.glsl). Same
sampling and the same float32 op order as ``theia_tpu.target``, so the
same Philox words give the same samples to float32 rounding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import units as u
from .component import Component
from .ops.math3d import distance, dot, intersect_sphere, local_frame, matvec, normalize, sign_bit, sqrt, vec3
from .ops.sampling import sample_direction_cone, sample_unit_disk, sample_unit_sphere
from .random import RNGState

__all__ = [
    "TargetSample",
    "Target",
    "SphereTarget",
    "InnerSphereTarget",
    "FlatTarget",
    "DiskTarget",
    "TargetGuideSample",
    "TargetGuide",
    "SphereTargetGuide",
    "FlatTargetGuide",
    "DiskTargetGuide",
]


@dataclass(frozen=True)
class TargetSample:
    """Sampled/intersected point on a target
    (reference: shader/target.common.glsl:4-16).

    ``offset``/``world_to_obj`` give the world->object transform as
    obj = world_to_obj @ world + offset (orthogonal part only)."""

    position: torch.Tensor  # f32[N,3] world space
    normal: torch.Tensor  # f32[N,3] world space
    dist: torch.Tensor  # f32[N] observer->sample distance
    obj_position: torch.Tensor  # f32[N,3]
    obj_normal: torch.Tensor  # f32[N,3]
    prob: torch.Tensor  # f32[N] sample probability over area
    valid: torch.Tensor  # bool[N]
    offset: torch.Tensor  # f32[N,3]
    world_to_obj: torch.Tensor  # f32[N,3,3]


class Target(Component):
    """Base class for targets (reference: src/theia/target.py:37-75)."""

    name = "Target"
    nRNGSamples: int = 0

    def sample(self, params, observer: torch.Tensor, rng: RNGState):
        raise NotImplementedError

    def intersect(self, params, observer: torch.Tensor, direction: torch.Tensor) -> TargetSample:
        raise NotImplementedError

    def occluded(self, params, position: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _eye3(shape, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(*shape, 3, 3)


class _SphereBase(Target):
    nRNGSamples = 2
    _param_names = ("position", "radius")

    def __init__(self, *, position=(0.0, 0.0, 0.0), radius: float = 1.0 * u.m):
        self.position = position
        self.radius = radius

    def _common(self, params, shape, area):
        center = torch.broadcast_to(params["position"], (*shape, 3))
        r = params["radius"]
        inv_pos = -center / r
        world_to_obj = _eye3(shape, center.device) / r
        return center, r, inv_pos, world_to_obj, 1.0 / (area * np.pi * r * r)

    def occluded(self, params, position):
        center = torch.broadcast_to(params["position"], position.shape)
        d = distance(position, center)
        return d <= params["radius"] if self._outside else d >= params["radius"]


class SphereTarget(_SphereBase):
    """Sphere sampled via its visible cap; object space is the unit sphere
    at the origin (reference: src/theia/target.py:78-141,
    shader/target.sphere.glsl)."""

    name = "Sphere Target"
    _outside = True

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, hemi_prob = self._common(params, shape, 2.0)
        axis = normalize(observer - center)  # center -> observer
        cos_opening = r / distance(observer, center)
        (u1, u2), rng = rng.uniform2d()
        local = sample_direction_cone(cos_opening, u1, u2)
        vx, vy = local_frame(axis)
        normal = local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * axis
        pos = normal * r + center
        prob = hemi_prob / (1.0 - cos_opening)
        valid = ~torch.isinf(prob)
        sample = TargetSample(
            position=pos,
            normal=normal,
            dist=distance(pos, observer),
            obj_position=normal,
            obj_normal=normal,
            prob=torch.where(valid, prob, 0.0),
            valid=valid,
            offset=inv_pos,
            world_to_obj=w2o,
        )
        return sample, rng

    def intersect(self, params, observer, direction):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, hemi_prob = self._common(params, shape, 2.0)
        t, _ = intersect_sphere(center, r, observer, direction)
        hit = (t > 0.0) & ~torch.isinf(t)
        pos = observer + direction * torch.where(hit, t, 1.0)[..., None]
        nrm = normalize(pos - center)
        prob = hemi_prob / (1.0 - r / distance(observer, center))
        valid = hit & ~torch.isinf(prob)
        return TargetSample(
            position=pos,
            normal=nrm,
            dist=torch.where(hit, t, torch.inf),
            obj_position=nrm,
            obj_normal=nrm,
            prob=torch.where(valid, prob, 0.0),
            valid=valid,
            offset=inv_pos,
            world_to_obj=w2o,
        )


class InnerSphereTarget(_SphereBase):
    """Sphere detected from the inside (reference:
    src/theia/target.py:142-201, shader/target.sphere.inner.glsl)."""

    name = "Inner Sphere Target"
    _outside = False

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, prob = self._common(params, shape, 4.0)
        (u1, u2), rng = rng.uniform2d()
        normal = sample_unit_sphere(u1, u2)
        pos = r * normal + center
        sample = TargetSample(
            position=pos,
            normal=-normal,
            dist=distance(observer, pos),
            obj_position=normal,
            obj_normal=-normal,
            prob=torch.broadcast_to(prob, shape),
            valid=torch.ones(shape, dtype=torch.bool, device=observer.device),
            offset=inv_pos,
            world_to_obj=w2o,
        )
        return sample, rng

    def intersect(self, params, observer, direction):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, prob = self._common(params, shape, 4.0)
        _, t = intersect_sphere(center, r, observer, direction)  # far hit
        hit = (t > 0.0) & ~torch.isinf(t)
        pos = observer + direction * torch.where(hit, t, 1.0)[..., None]
        nrm = normalize(center - pos)
        return TargetSample(
            position=pos,
            normal=nrm,
            dist=torch.where(hit, t, torch.inf),
            obj_position=-nrm,
            obj_normal=nrm,
            prob=torch.broadcast_to(prob, shape),
            valid=hit,
            offset=inv_pos,
            world_to_obj=w2o,
        )


def _orient_frame(normal, up) -> np.ndarray:
    """Orthonormal obj->world columns (x, y, z=normal) from normal+up
    (reference: Transform.View), computed on the host in float64 as
    ``theia_tpu.target._orient_frame`` does."""
    z = np.asarray(normal, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    if np.linalg.norm(x) < 1e-12:
        raise ValueError("normal and up may not be parallel")
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32)  # columns


class _PlanarTarget(Target):
    """Shared machinery for rect/disk planar targets
    (reference: shader/target.flat.glsl, target.disk.glsl)."""

    nRNGSamples = 2
    _extra_names = ("direction", "up")

    def __init__(self, *, position, direction, up) -> None:
        self.position = position
        self.direction = direction
        self.up = up
        self.update()

    def update(self) -> None:
        m = _orient_frame(self.direction, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._prob = 1.0 / self._area()

    def params(self, device):
        self.update()
        return super().params(device)

    def _frames(self, params, shape):
        o2w = torch.broadcast_to(params["_objToWorld"], (*shape, 3, 3))
        w2o = o2w.transpose(-1, -2)
        pos = torch.broadcast_to(params["position"], (*shape, 3))
        nrm = torch.broadcast_to(params["_normal"], (*shape, 3))
        return o2w, w2o, pos, nrm

    def _sample_local(self, params, rng):
        raise NotImplementedError

    def _inside(self, params, local_pos):
        raise NotImplementedError

    @staticmethod
    def _obj_normal(side):
        zero = torch.zeros_like(side)
        return vec3(zero, zero, side)

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        o2w, w2o, offset, base_nrm = self._frames(params, shape)
        local, rng = self._sample_local(params, rng)
        pos = matvec(o2w, local) + offset
        side = torch.sign(dot(base_nrm, observer - pos))
        normal = base_nrm * side[..., None]
        sample = TargetSample(
            position=pos,
            normal=normal,
            dist=distance(observer, pos),
            obj_position=local,
            obj_normal=self._obj_normal(side),
            prob=torch.broadcast_to(params["_prob"], shape),
            valid=dot(normal, normal) != 0.0,
            offset=-matvec(w2o, offset),
            world_to_obj=w2o,
        )
        return sample, rng

    def intersect(self, params, observer, direction):
        shape = observer.shape[:-1]
        o2w, w2o, offset, base_nrm = self._frames(params, shape)
        local_obs = matvec(w2o, observer - offset)
        local_dir = matvec(w2o, direction)
        dz = local_dir[..., 2]
        t = -local_obs[..., 2] / torch.where(torch.abs(dz) > 1e-12, dz, 1e-12)
        local_pos = local_obs + t[..., None] * local_dir
        valid = (t > 0.0) & self._inside(params, local_pos)
        side = sign_bit(local_obs[..., 2])
        return TargetSample(
            position=matvec(o2w, local_pos) + offset,
            normal=base_nrm * side[..., None],
            dist=torch.where(valid, t, torch.inf),
            obj_position=local_pos,
            obj_normal=self._obj_normal(side),
            prob=torch.broadcast_to(params["_prob"], shape) * valid.to(torch.float32),
            valid=valid,
            offset=-matvec(w2o, offset),
            world_to_obj=w2o,
        )

    def occluded(self, params, position):
        return torch.zeros(position.shape[:-1], dtype=torch.bool, device=position.device)


class FlatTarget(_PlanarTarget):
    """Rectangular target (reference: src/theia/target.py:202-324)."""

    name = "Flat Target"
    _param_names = ("width", "length", "position", "_normal", "_prob", "_objToWorld")

    def __init__(
        self,
        *,
        width: float = 1.0 * u.cm,
        length: float = 1.0 * u.cm,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.width = width
        self.length = length
        super().__init__(position=position, direction=direction, up=up)

    def _area(self) -> float:
        return self.width * self.length

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        local = vec3(params["width"] * (u1 - 0.5), params["length"] * (u2 - 0.5), torch.zeros_like(u1))
        return local, rng

    def _inside(self, params, local_pos):
        return (2.0 * torch.abs(local_pos[..., 0]) <= params["width"]) & (
            2.0 * torch.abs(local_pos[..., 1]) <= params["length"]
        )


class DiskTarget(_PlanarTarget):
    """Disk target (reference: src/theia/target.py:325-424)."""

    name = "Disk Target"
    _param_names = ("radius", "position", "_normal", "_prob", "_objToWorld")

    def __init__(
        self,
        *,
        radius: float = 1.0 * u.cm,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.radius = radius
        super().__init__(position=position, direction=direction, up=up)

    def _area(self) -> float:
        return np.pi * self.radius**2

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        return params["radius"] * sample_unit_disk(u1, u2), rng

    def _inside(self, params, local_pos):
        r2 = local_pos[..., 0] ** 2 + local_pos[..., 1] ** 2
        return r2 <= params["radius"] ** 2


@dataclass(frozen=True)
class TargetGuideSample:
    """Guide sample: direction + max trace distance + solid-angle pdf
    (reference: shader/target_guide.common.glsl:4-9)."""

    direction: torch.Tensor  # f32[N,3]
    dist: torch.Tensor  # f32[N]
    prob: torch.Tensor  # f32[N]


class TargetGuide(Component):
    """Base class for target guides (reference: src/theia/target.py:427-469)."""

    name = "Target Guide"
    nRNGSamples: int = 0

    def sample(self, params, observer, rng: RNGState):
        raise NotImplementedError

    def eval(self, params, observer, direction) -> TargetGuideSample:
        raise NotImplementedError


def _sqrt_positive(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero gradient where x <= 0: the value of
    ``theia_tpu``'s ``jnp.sqrt(jnp.maximum(x, 0))``, without its infinite
    slope at 0, which turns the gradient of every lane behind it into
    NaN (0 * inf). A deliberate divergence: in ``theia_tpu`` one guide
    sample at cos theta = 1 (a narrow cone, or u = 0) makes d/d(source
    position) and d/d(detector position) NaN
    (tests/test_torch_grad_geometry.py holds both)."""
    positive = x > 0.0
    return torch.where(positive, sqrt(torch.where(positive, x, 1.0)), 0.0)


class SphereTargetGuide(TargetGuide):
    """Samples the cone subtending a sphere, weighted toward passing fully
    through it (reference: src/theia/target.py:470-527)."""

    name = "Sphere Target Guide"
    nRNGSamples = 2
    _param_names = ("position", "radius")

    def __init__(self, *, position=(0.0, 0.0, 0.0), radius: float = 1.0 * u.m):
        self.position = position
        self.radius = radius

    def _cone(self, params, observer):
        center = torch.broadcast_to(params["position"], observer.shape)
        d = distance(center, observer)
        view_dir = normalize(center - observer)
        sin_max = params["radius"] / d
        sin2 = sin_max * sin_max
        cos_min = 1.0 - _sqrt_positive(1.0 - sin2)
        # Taylor fallback for narrow cones (f32 catastrophic cancellation)
        cos_min = torch.where(sin2 < 0.00068523, 0.5 * sin2, cos_min)
        prob = 1.0 / (2.0 * np.pi * cos_min)
        prob = prob * (d > params["radius"]).to(torch.float32)
        return view_dir, cos_min, prob, d + params["radius"]

    def sample(self, params, observer, rng: RNGState):
        view_dir, cos_min, prob, dist = self._cone(params, observer)
        (u1, u2), rng = rng.uniform2d()
        cos_theta = 1.0 - cos_min * u1
        sin_theta = _sqrt_positive(1.0 - cos_theta * cos_theta)
        phi = 2.0 * np.pi * u2
        vx, vy = local_frame(view_dir)
        direction = (
            (sin_theta * torch.sin(phi))[..., None] * vx
            + (sin_theta * torch.cos(phi))[..., None] * vy
            + cos_theta[..., None] * view_dir
        )
        return TargetGuideSample(direction, dist, prob), rng

    def eval(self, params, observer, direction) -> TargetGuideSample:
        view_dir, cos_min, prob, dist = self._cone(params, observer)
        cos_dir = dot(view_dir, direction)
        prob = prob * (cos_min >= 1.0 - cos_dir).to(torch.float32)
        return TargetGuideSample(direction, dist, prob)


def _guide_sample_from_point(observer, pos, normal, prob_area, dist=None):
    """createTargetGuideSample: an area pdf turned into a solid-angle pdf,
    zero from the wrong side of the surface and where the conversion
    overflows (reference: shader/target_guide.common.glsl:10-32)."""
    d = pos - observer
    d2 = torch.clamp_min(dot(d, d), 1e-30)
    direction = d / sqrt(d2)[..., None]
    cos_normal = dot(direction, normal)
    prob = prob_area * d2 / torch.clamp_min(torch.abs(cos_normal), 1e-30)
    prob = torch.where(torch.isinf(prob), 0.0, prob)
    prob = prob * (cos_normal < 0.0).to(torch.float32)
    if dist is None:
        dist = sqrt(d2)
    return TargetGuideSample(direction, dist, prob)


class _PlanarTargetGuide(TargetGuide):
    """Shared rect/disk guide machinery: a point drawn on the plane in its
    own frame, or the plane hit along a direction
    (reference: shader/target_guide.flat.glsl, target_guide.disk.glsl)."""

    nRNGSamples = 2
    _extra_names = ("normal", "up")

    def __init__(self, *, position, normal, up) -> None:
        self.position = position
        self.normal = normal
        self.up = up
        self.update()

    def update(self) -> None:
        m = _orient_frame(self.normal, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._prob = 1.0 / self._area()

    def params(self, device):
        self.update()
        return super().params(device)

    def _frame(self, params, shape):
        o2w = torch.broadcast_to(params["_objToWorld"], (*shape, 3, 3))
        offset = torch.broadcast_to(params["position"], (*shape, 3))
        nrm = torch.broadcast_to(params["_normal"], (*shape, 3))
        return o2w, offset, nrm

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        o2w, offset, nrm = self._frame(params, shape)
        local, rng = self._sample_local(params, rng)
        pos = matvec(o2w, local) + offset
        prob = torch.broadcast_to(params["_prob"], shape)
        return _guide_sample_from_point(observer, pos, nrm, prob), rng

    def eval(self, params, observer, direction) -> TargetGuideSample:
        shape = observer.shape[:-1]
        o2w, offset, nrm = self._frame(params, shape)
        w2o = o2w.transpose(-1, -2)
        local_obs = matvec(w2o, observer - offset)
        local_dir = matvec(w2o, direction)
        dz = local_dir[..., 2]
        t = -local_obs[..., 2] / torch.where(torch.abs(dz) > 1e-12, dz, 1e-12)
        local_pos = local_obs + t[..., None] * local_dir
        inside = (t > 0.0) & self._inside(params, local_pos)
        cos_normal = dot(direction, nrm)
        prob_area = torch.broadcast_to(params["_prob"], shape)
        prob = prob_area * t * t / torch.clamp_min(torch.abs(cos_normal), 1e-30)
        prob = torch.where(torch.isinf(prob), 0.0, prob)
        prob = prob * (cos_normal < 0.0).to(torch.float32)
        prob = prob * inside.to(torch.float32)
        return TargetGuideSample(direction, torch.where(inside, t, torch.inf), prob)


class FlatTargetGuide(_PlanarTargetGuide):
    """Rectangular target guide (reference: src/theia/target.py:528-637)."""

    name = "Flat Target Guide"
    _param_names = ("width", "height", "position", "_normal", "_prob", "_objToWorld")

    def __init__(
        self,
        *,
        width: float = 1.0 * u.m,
        height: float = 1.0 * u.m,
        position=(0.0, 0.0, 0.0),
        normal=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.width = width
        self.height = height
        super().__init__(position=position, normal=normal, up=up)

    def _area(self) -> float:
        return self.width * self.height

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        local = vec3(params["width"] * (u1 - 0.5), params["height"] * (u2 - 0.5), torch.zeros_like(u1))
        return local, rng

    def _inside(self, params, local_pos):
        return (2.0 * torch.abs(local_pos[..., 0]) <= params["width"]) & (
            2.0 * torch.abs(local_pos[..., 1]) <= params["height"]
        )


class DiskTargetGuide(_PlanarTargetGuide):
    """Disk target guide (reference: src/theia/target.py:639-736)."""

    name = "Disk Target Guide"
    _param_names = ("radius", "position", "_normal", "_prob", "_objToWorld")

    def __init__(
        self,
        *,
        radius: float = 1.0 * u.m,
        position=(0.0, 0.0, 0.0),
        normal=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.radius = radius
        super().__init__(position=position, normal=normal, up=up)

    def _area(self) -> float:
        return np.pi * self.radius**2

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        return params["radius"] * sample_unit_disk(u1, u2), rng

    def _inside(self, params, local_pos):
        r2 = local_pos[..., 0] ** 2 + local_pos[..., 1] ** 2
        return r2 <= params["radius"] ** 2
