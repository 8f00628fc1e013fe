"""Cameras: where backward and direct tracing start.

The port of ``theia_tpu.camera``. A camera samples rays leaving the
detector (backward tracing) or detector points that light samples connect
to (direct tracing). Hits are reported in the camera's object space, so
responses do not depend on its pose; the hit position may differ from the
ray's origin to model lenses and housings (reference:
src/theia/camera.py:39-75, shader/camera.common.glsl). Draw counts
(``nRNGSamples``, ``nRNGDirect``) are ``theia_tpu``'s, so the same
generator gives the same samples.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import units as u
from .component import Component, host_dict
from .ops.math3d import (
    cross,
    dot,
    local_frame,
    matvec,
    normalize,
    perpendicular_to,
    perpendicular_to2,
    perpendicular_to_z_and,
    sign_bit,
    sqrt,
    vec3,
)
from .ops.sampling import FOUR_PI, TWO_PI, sample_direction_cone, sample_hemisphere, sample_unit_sphere
from .polarization import rotation_coeffs, rotation_mueller
from .random import RNGState

__all__ = [
    "CameraRay",
    "CameraSample",
    "Camera",
    "PencilCamera",
    "FlatCamera",
    "ConeCamera",
    "SphereCamera",
    "PointCamera",
    "MeshCamera",
    "HostCamera",
    "CameraRayItem",
    "PolarizedCameraRayItem",
    "CameraRaySampler",
]


@dataclass(frozen=True)
class CameraRay:
    """A ray leaving the detector and the detector-space hit it stands for
    (reference: shader/camera.common.glsl:34-47)."""

    position: torch.Tensor  # f32[N,3]
    direction: torch.Tensor  # f32[N,3]
    contrib: torch.Tensor  # f32[N]
    time_delta: torch.Tensor  # f32[N]
    hit_position: torch.Tensor  # f32[N,3] object space
    hit_direction: torch.Tensor  # f32[N,3] object space
    hit_normal: torch.Tensor  # f32[N,3] object space
    object_id: torch.Tensor  # i32[N]
    pol_ref: torch.Tensor | None = None  # f32[N,3]
    hit_pol_ref: torch.Tensor | None = None  # f32[N,3]
    #: the rotation of the world frame onto the (object-space) hit frame,
    #: the start of a backward ray's Mueller matrix
    mueller: torch.Tensor | None = None  # f32[N,4,4]


@dataclass(frozen=True)
class CameraSample:
    """A detector point for direct connections
    (reference: shader/camera.common.glsl:8-20)."""

    position: torch.Tensor  # f32[N,3]
    normal: torch.Tensor  # f32[N,3]
    contrib: torch.Tensor  # f32[N]
    object_id: torch.Tensor  # i32[N]
    # the object-space point where that space is not the world's
    # (MeshCamera); None: position and normal serve both
    obj_position: torch.Tensor | None = None  # f32[N,3]
    obj_normal: torch.Tensor | None = None  # f32[N,3]


def _ids(shape, device) -> torch.Tensor:
    return torch.full(shape, -1, dtype=torch.int32, device=device)


def _identity_mueller(shape, device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(*shape, 4, 4)


def _z_axis(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=like.device).expand(like.shape)


def _lanes3(v, shape) -> torch.Tensor:
    return torch.broadcast_to(v, (*shape, 3))


def _in_frame(local: torch.Tensor, vx, vy, vz) -> torch.Tensor:
    """``local``'s coordinates taken along the frame (vx, vy, vz)."""
    return local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * vz


def _perp_host(v) -> np.ndarray:
    """Host-side perpendicularTo (reference: math.glsl:58-64)."""
    v = np.asarray(v, np.float64)
    v = v / np.linalg.norm(v)
    other = np.array([0.0, 1.0, 0.0]) if abs(v[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    p = np.cross(v, other)
    return p / np.linalg.norm(p)


def _pol_fields(ray_dir, world_nrm, hit_dir, hit_nrm, o2w_lin=None, *, towards=False):
    """Polarization frames of a camera ray: the world frame perpendicular
    to the plane of incidence, the object-space hit frame, and the Mueller
    rotation of the first onto the second as the photon arrives (along
    ``-ray_dir``, or along ``ray_dir`` itself where ``towards``, for a
    direct connection) (reference: camera.mesh.glsl POLARIZATION)."""
    hit_pol_ref = perpendicular_to2(hit_dir, hit_nrm)
    pol_ref = perpendicular_to2(ray_dir, world_nrm)
    expected = hit_pol_ref if o2w_lin is None else normalize(hit_pol_ref @ o2w_lin.T)
    c, s = rotation_coeffs(ray_dir if towards else -ray_dir, pol_ref, expected)
    return pol_ref, hit_pol_ref, rotation_mueller(c, s)


class Camera(Component):
    """Base camera (reference: src/theia/camera.py:39-75)."""

    name = "Camera"
    nRNGSamples: int = 0
    nRNGDirect: int = 0
    supportDirect: bool = False

    def sample_ray(self, params, wavelength, rng: RNGState) -> tuple[CameraRay, RNGState]:
        raise NotImplementedError

    def sample_point(self, params, wavelength, rng: RNGState) -> tuple[CameraSample, RNGState]:
        """sampleCamera: a detector point for direct lighting."""
        raise NotImplementedError

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength) -> CameraRay:
        """createCameraRay(sample, lightDir): complete a direct connection."""
        raise NotImplementedError


class PencilCamera(Camera):
    """One fixed ray (reference: src/theia/camera.py:350-427,
    shader/camera.pencil.glsl)."""

    name = "Pencil Camera"
    nRNGSamples = 0
    _param_names = (
        "rayPosition", "rayDirection", "timeDelta", "hitPosition", "hitDirection", "hitNormal",
        "rayPolRef", "hitPolRef",
    )

    def __init__(
        self,
        *,
        rayPosition=(0.0, 0.0, 0.0),
        rayDirection=(0.0, 0.0, 1.0),
        timeDelta: float = 0.0,
        hitPosition=(0.0, 0.0, 0.0),
        hitDirection=(0.0, 0.0, -1.0),
        hitNormal=(0.0, 0.0, 1.0),
        rayPolRef=None,
        hitPolRef=None,
    ) -> None:
        self.rayPosition = rayPosition
        self.rayDirection = rayDirection
        self.timeDelta = timeDelta
        self.hitPosition = hitPosition
        self.hitDirection = hitDirection
        self.hitNormal = hitNormal
        if rayPolRef is None:
            rayPolRef = tuple(np.asarray(_perp_host(rayDirection), np.float32))
        if hitPolRef is None:
            hitPolRef = tuple(np.asarray(_perp_host(hitDirection), np.float32))
        self.rayPolRef = rayPolRef
        self.hitPolRef = hitPolRef

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape, dev = rng.stream.shape, rng.stream.device
        b = lambda k: _lanes3(params[k], shape)
        # explicit frames with the identity Mueller matrix (camera.pencil.glsl)
        return (
            CameraRay(
                position=b("rayPosition"),
                direction=b("rayDirection"),
                contrib=torch.ones(shape, dtype=torch.float32, device=dev),
                time_delta=torch.broadcast_to(params["timeDelta"], shape),
                hit_position=b("hitPosition"),
                hit_direction=b("hitDirection"),
                hit_normal=b("hitNormal"),
                object_id=_ids(shape, dev),
                pol_ref=normalize(b("rayPolRef")),
                hit_pol_ref=normalize(b("hitPolRef")),
                mueller=_identity_mueller(shape, dev),
            ),
            rng,
        )


class FlatCamera(Camera):
    """Rectangular detector whose local frame a view matrix gives
    (reference: src/theia/camera.py:468-577, shader/camera.flat.glsl).
    ``view`` maps world to object coordinates."""

    name = "Flat Camera"
    nRNGSamples = 4
    nRNGDirect = 2
    supportDirect = True
    _param_names = ("width", "length", "offset", "view")

    def __init__(self, *, width: float = 1.0 * u.cm, length: float = 1.0 * u.cm, offset=(0.0, 0.0, 0.0), view=None):
        self.width = width
        self.length = length
        self.offset = offset
        self.view = np.eye(3, dtype=np.float32) if view is None else np.asarray(view, np.float32)

    def _local_point(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        local_pos = vec3(params["width"] * (u1 - 0.5), params["length"] * (u2 - 0.5), torch.zeros_like(u1))
        return local_pos, rng

    def _o2w(self, params, shape):
        # the inverse of the orthogonal view matrix is its transpose
        return params["view"].transpose(0, 1).expand(*shape, 3, 3)

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        o2w = self._o2w(params, shape)
        local_pos, rng = self._local_point(params, rng)
        ray_pos = matvec(o2w, local_pos) + params["offset"]
        (u3, u4), rng = rng.uniform2d()
        local_dir = sample_hemisphere(u3, u4)
        cos_theta = local_dir[..., 2]
        ray_dir = matvec(o2w, local_dir)
        local_dir = -local_dir
        contrib = TWO_PI * params["width"] * params["length"] * cos_theta
        z = _z_axis(local_pos)
        world_nrm = matvec(o2w, z)
        hit_pol_ref = perpendicular_to2(local_dir, z)
        pol_ref = perpendicular_to2(ray_dir, world_nrm)
        pc, ps = rotation_coeffs(-ray_dir, pol_ref, matvec(o2w, hit_pol_ref))
        return (
            CameraRay(
                position=ray_pos,
                direction=ray_dir,
                contrib=contrib,
                time_delta=torch.zeros_like(contrib),
                hit_position=local_pos,
                hit_direction=local_dir,
                hit_normal=z,
                object_id=_ids(shape, contrib.device),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=rotation_mueller(pc, ps),
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        o2w = self._o2w(params, shape)
        local_pos, rng = self._local_point(params, rng)
        pos = matvec(o2w, local_pos) + params["offset"]
        nrm = matvec(o2w, _z_axis(local_pos))
        contrib = torch.broadcast_to(params["width"] * params["length"], shape)
        return CameraSample(pos, nrm, contrib, _ids(shape, pos.device)), rng

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        view = params["view"].expand(*shape, 3, 3)
        local_pos = matvec(view, cam.position - params["offset"])
        local_dir = matvec(view, light_dir)
        contrib = cam.contrib * -local_dir[..., 2]
        contrib = contrib * (dot(cam.normal, light_dir) < 0.0).to(torch.float32)
        z = _z_axis(local_pos)
        hit_pol_ref = perpendicular_to2(local_dir, z)
        pol_ref = perpendicular_to2(light_dir, cam.normal)
        pc, ps = rotation_coeffs(light_dir, pol_ref, matvec(self._o2w(params, shape), hit_pol_ref))
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=torch.zeros_like(contrib),
            hit_position=local_pos,
            hit_direction=local_dir,
            hit_normal=z,
            object_id=cam.object_id,
            pol_ref=pol_ref,
            hit_pol_ref=hit_pol_ref,
            mueller=rotation_mueller(pc, ps),
        )


class ConeCamera(Camera):
    """Point detector taking a cone of directions
    (reference: src/theia/camera.py:580-632, shader/camera.cone.glsl)."""

    name = "Cone Camera"
    nRNGSamples = 2
    nRNGDirect = 0
    supportDirect = True
    _param_names = ("position", "direction", "cosOpeningAngle")

    def __init__(self, *, position=(0.0, 0.0, 0.0), direction=(0.0, 0.0, 1.0), cosOpeningAngle: float = 1.0):
        self.position = position
        self.direction = direction
        self.cosOpeningAngle = cosOpeningAngle

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (u1, u2), rng = rng.uniform2d()
        local_dir = sample_direction_cone(params["cosOpeningAngle"], u1, u2)
        axis = _lanes3(params["direction"], shape)
        vx, vy = local_frame(axis)
        ray_dir = _in_frame(local_dir, vx, vy, axis)
        local_dir = -local_dir
        contrib = torch.broadcast_to(TWO_PI * (1.0 - params["cosOpeningAngle"]), shape)
        zero = torch.zeros_like(ray_dir)
        # camera.cone.glsl:22-34: the identity Mueller matrix, the frame
        # carried from local to world by the cone's basis
        hit_pol_ref = perpendicular_to_z_and(local_dir)
        return (
            CameraRay(
                position=_lanes3(params["position"], shape),
                direction=ray_dir,
                contrib=contrib,
                time_delta=torch.zeros(shape, dtype=torch.float32, device=zero.device),
                hit_position=zero,
                hit_direction=local_dir,
                hit_normal=_z_axis(zero),
                object_id=_ids(shape, zero.device),
                pol_ref=_in_frame(hit_pol_ref, vx, vy, axis),
                hit_pol_ref=hit_pol_ref,
                mueller=_identity_mueller(shape, zero.device),
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape, dev = rng.stream.shape, rng.stream.device
        return (
            CameraSample(
                position=_lanes3(params["position"], shape),
                normal=_lanes3(params["direction"], shape),
                contrib=torch.ones(shape, dtype=torch.float32, device=dev),
                object_id=_ids(shape, dev),
            ),
            rng,
        )

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        axis = _lanes3(params["direction"], shape)
        # theia_tpu's fix over camera.cone.glsl:55 (which accepts cos >= 1 - c
        # where sampling takes cos >= c): accept the sampled cone
        contrib = (dot(axis, -light_dir) >= params["cosOpeningAngle"]).to(torch.float32)
        vx, vy = local_frame(axis)
        hit_dir = torch.stack([dot(vx, light_dir), dot(vy, light_dir), dot(axis, light_dir)], dim=-1)
        zero = torch.zeros_like(hit_dir)
        hit_pol_ref = perpendicular_to_z_and(hit_dir)
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=torch.zeros(shape, dtype=torch.float32, device=zero.device),
            hit_position=zero,
            hit_direction=hit_dir,
            hit_normal=_z_axis(zero),
            object_id=cam.object_id,
            pol_ref=_in_frame(hit_pol_ref, vx, vy, axis),
            hit_pol_ref=hit_pol_ref,
            mueller=_identity_mueller(shape, zero.device),
        )


class SphereCamera(Camera):
    """Spherical detector whose object space is the unit sphere; a
    negative radius turns its surface inward
    (reference: src/theia/camera.py:635-701, shader/camera.sphere.glsl)."""

    name = "Sphere Camera"
    nRNGSamples = 4
    nRNGDirect = 2
    supportDirect = True
    _param_names = ("position", "radius", "timeDelta")

    def __init__(self, *, position=(0.0, 0.0, 0.0), radius: float = 1.0 * u.m, timeDelta: float = 0.0):
        self.position = position
        self.radius = radius
        self.timeDelta = timeDelta

    def _surface_point(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        normal = sample_unit_sphere(u1, u2)
        return normal, params["radius"] * normal + params["position"], rng

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        r = params["radius"]
        normal, ray_pos, rng = self._surface_point(params, rng)
        (u3, u4), rng = rng.uniform2d()
        local = sample_hemisphere(u3, u4)
        vx, vy = local_frame(normal)
        ray_dir = _in_frame(local, vx, vy, normal)
        contrib = local[..., 2] * (float(np.float32(4.0 * np.pi * 2.0 * np.pi)) * r * r)
        pol_ref, hit_pol_ref, mueller = _pol_fields(ray_dir, normal, -ray_dir, normal)
        return (
            CameraRay(
                position=ray_pos,
                direction=ray_dir,
                contrib=contrib,
                time_delta=torch.broadcast_to(params["timeDelta"], shape),
                hit_position=normal,
                # object space is the unit sphere, unrotated: the incident
                # direction there is the negated world direction
                hit_direction=-ray_dir,
                hit_normal=normal,
                object_id=_ids(shape, normal.device),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=mueller,
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        r = params["radius"]
        normal, pos, rng = self._surface_point(params, rng)
        contrib = torch.broadcast_to(float(np.float32(4.0 * np.pi)) * r * r, shape)
        return CameraSample(pos, normal, contrib, _ids(shape, pos.device)), rng

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        contrib = cam.contrib * dot(light_dir, -cam.normal)
        contrib = contrib * (dot(cam.normal, light_dir) < 0.0).to(torch.float32)
        pol_ref, hit_pol_ref, mueller = _pol_fields(light_dir, cam.normal, light_dir, cam.normal, towards=True)
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=torch.broadcast_to(params["timeDelta"], shape),
            hit_position=cam.normal,
            hit_direction=light_dir,
            hit_normal=cam.normal,
            object_id=cam.object_id,
            pol_ref=pol_ref,
            hit_pol_ref=hit_pol_ref,
            mueller=mueller,
        )


class MeshCamera(Camera):
    """Rays from the surface of a mesh instance
    (reference: src/theia/camera.py:746-860, shader/camera.mesh.glsl), as
    ``theia_tpu`` estimates them: a triangle drawn uniformly by count and
    compensated by ``area * triangle count``, a point uniform in it by the
    (1 - sqrt(u), v sqrt(u)) warp, a direction uniform on the hemisphere
    above the geometric normal (flipped with ``inward``, aligned in sign
    with the interpolated vertex normal) with ``contrib *= cos 2 pi``. The
    area factor takes only the transform's linear part (the reference adds
    the translation to the edges too, camera.mesh.glsl:52-53)."""

    name = "Mesh Camera"
    nRNGSamples = 5
    nRNGDirect = 3
    supportDirect = True
    _param_names = ("timeDelta",)
    _extra_names = ("mesh", "inward")

    def __init__(self, mesh, *, timeDelta: float = 0.0, inward: bool = False) -> None:
        self.mesh = mesh
        self.timeDelta = timeDelta
        self.inward = inward

    def params(self, device):
        m = self.mesh.mesh
        idx = m.indices
        pos, nrm = m.vertices[:, :3], m.vertices[:, 3:6]
        v0 = pos[idx[:, 0]]
        f32 = lambda a: (a, np.float32)
        return host_dict({
            "timeDelta": f32(self.timeDelta),
            "outward": f32(-1.0 if self.inward else 1.0),
            "v0": f32(v0),
            "e1": f32(pos[idx[:, 1]] - v0),
            "e2": f32(pos[idx[:, 2]] - v0),
            "n0": f32(nrm[idx[:, 0]]),
            "n1": f32(nrm[idx[:, 1]]),
            "n2": f32(nrm[idx[:, 2]]),
            "o2w": f32(self.mesh.transform.numpy()),
            "w2o": f32(self.mesh.transform.inverse().numpy()),
        }, device)

    def _sample_surface(self, params, rng: RNGState):
        """sampleCamera's three draws: the point in world and object space
        and its contribution."""
        from .accel import offset_ray

        n_tri = params["v0"].shape[0]
        u1, rng = rng.uniform()
        tri = torch.clamp_max(torch.floor(u1 * n_tri).to(torch.int64), n_tri - 1)
        g = lambda name: params[name][tri]
        v0, e1, e2 = g("v0"), g("e1"), g("e2")
        (b1, b2), rng = rng.uniform2d()
        sb = sqrt(b1)
        b1 = 1.0 - sb
        b2 = b2 * sb
        local_pos = v0 + b1[..., None] * e1 + b2[..., None] * e2
        local_nrm = normalize(cross(e1, e2))
        n0 = g("n0")
        int_nrm = n0 + b1[..., None] * (g("n1") - n0) + b2[..., None] * (g("n2") - n0)
        local_nrm = local_nrm * sign_bit(dot(local_nrm, int_nrm))[..., None]
        local_nrm = local_nrm * params["outward"]

        o2w = params["o2w"]
        lin, off = o2w[:3, :3], o2w[:3, 3]
        # normals take the inverse transpose: n' = n @ w2o[:3, :3]
        ray_nrm = normalize(local_nrm @ params["w2o"][:3, :3])
        ray_pos = offset_ray(local_pos @ lin.T + off, ray_nrm)
        we1, we2 = e1 @ lin.T, e2 @ lin.T
        area = 0.5 * sqrt(torch.clamp_min(dot(cross(we1, we2), cross(we1, we2)), 1e-30))
        return (ray_pos, ray_nrm, local_pos, local_nrm, area * float(n_tri)), rng

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (ray_pos, ray_nrm, local_pos, local_nrm, contrib), rng = self._sample_surface(params, rng)
        (u3, u4), rng = rng.uniform2d()
        local = sample_hemisphere(u3, u4)
        vx, vy = local_frame(local_nrm)
        local_dir = _in_frame(local, vx, vy, local_nrm)
        lin = params["o2w"][:3, :3]
        ray_dir = normalize(local_dir @ lin.T)
        contrib = contrib * local[..., 2] * TWO_PI
        pol_ref, hit_pol_ref, mueller = _pol_fields(ray_dir, ray_nrm, -local_dir, local_nrm, lin)
        return (
            CameraRay(
                position=ray_pos,
                direction=ray_dir,
                contrib=contrib,
                time_delta=torch.broadcast_to(params["timeDelta"], shape),
                hit_position=local_pos,
                hit_direction=-local_dir,
                hit_normal=local_nrm,
                object_id=_ids(shape, ray_pos.device),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=mueller,
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (ray_pos, ray_nrm, local_pos, local_nrm, contrib), rng = self._sample_surface(params, rng)
        sample = CameraSample(
            position=ray_pos, normal=ray_nrm, contrib=contrib, object_id=_ids(shape, ray_pos.device),
            obj_position=local_pos, obj_normal=local_nrm,
        )
        return sample, rng

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        contrib = cam.contrib * dot(light_dir, -cam.normal)
        contrib = contrib * (dot(cam.normal, light_dir) < 0.0).to(torch.float32)
        hit_dir = light_dir @ params["w2o"][:3, :3].T
        pol_ref, hit_pol_ref, mueller = _pol_fields(
            light_dir, cam.normal, hit_dir, cam.obj_normal, params["o2w"][:3, :3], towards=True
        )
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=torch.broadcast_to(params["timeDelta"], shape),
            hit_position=cam.obj_position,
            hit_direction=hit_dir,
            hit_normal=cam.obj_normal,
            object_id=cam.object_id,
            pol_ref=pol_ref,
            hit_pol_ref=hit_pol_ref,
            mueller=mueller,
        )


class PointCamera(Camera):
    """Isotropic point detector, ray mode only
    (reference: src/theia/camera.py:702-745, shader/camera.point.glsl)."""

    name = "Point Camera"
    nRNGSamples = 2
    _param_names = ("position", "timeDelta")

    def __init__(self, *, position=(0.0, 0.0, 0.0), timeDelta: float = 0.0):
        self.position = position
        self.timeDelta = timeDelta

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (u1, u2), rng = rng.uniform2d()
        direction = sample_unit_sphere(u1, u2)
        # camera.point.glsl:15-28: one perpendicular frame, the identity
        # Mueller matrix
        pol_ref = perpendicular_to(direction)
        return (
            CameraRay(
                position=_lanes3(params["position"], shape),
                direction=direction,
                contrib=torch.full(shape, FOUR_PI, dtype=torch.float32, device=direction.device),
                time_delta=torch.broadcast_to(params["timeDelta"], shape),
                hit_position=torch.zeros_like(direction),
                hit_direction=-direction,
                hit_normal=direction,
                object_id=_ids(shape, direction.device),
                pol_ref=pol_ref,
                hit_pol_ref=pol_ref,
                mueller=_identity_mueller(shape, direction.device),
            ),
            rng,
        )


class HostCamera(Camera):
    """Camera rays given by the host, a row a lane (its stream id modulo
    the rows); optional polarization frames with identity Mueller
    matrices (reference: src/theia/camera.py:270-349,
    shader/camera.queue.glsl CAMERA_QUEUE_POLARIZED)."""

    name = "Host Camera"
    nRNGSamples = 0
    _param_names = ("position", "direction", "contrib", "timeDelta", "hitPosition", "hitDirection", "hitNormal")

    def __init__(
        self, position, direction, contrib, timeDelta, hitPosition, hitDirection, hitNormal,
        polRef=None, hitPolRef=None,
    ) -> None:
        self.position = np.asarray(position, np.float32)
        self.direction = np.asarray(direction, np.float32)
        self.contrib = np.asarray(contrib, np.float32)
        self.timeDelta = np.asarray(timeDelta, np.float32)
        self.hitPosition = np.asarray(hitPosition, np.float32)
        self.hitDirection = np.asarray(hitDirection, np.float32)
        self.hitNormal = np.asarray(hitNormal, np.float32)
        self.polRef = None if polRef is None else np.asarray(polRef, np.float32)
        self.hitPolRef = None if hitPolRef is None else np.asarray(hitPolRef, np.float32)

    def params(self, device):
        p = super().params(device)
        if self.polRef is not None:
            hit_ref = self.hitPolRef if self.hitPolRef is not None else self.polRef
            p.update(host_dict({"polRef": (self.polRef, None), "hitPolRef": (hit_ref, None)}, device))
        return p

    def sample_ray(self, params, wavelength, rng: RNGState):
        idx = rng.stream.to(torch.int64) % params["contrib"].shape[0]
        take = lambda k: params[k][idx]
        pol_ref = hit_pol_ref = mueller = None
        if "polRef" in params:
            pol_ref, hit_pol_ref = take("polRef"), take("hitPolRef")
            mueller = _identity_mueller(idx.shape, idx.device)
        return (
            CameraRay(
                position=take("position"),
                direction=take("direction"),
                contrib=take("contrib"),
                time_delta=take("timeDelta"),
                hit_position=take("hitPosition"),
                hit_direction=take("hitDirection"),
                hit_normal=take("hitNormal"),
                object_id=_ids(idx.shape, idx.device),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=mueller,
            ),
            rng,
        )


from .items import CameraRayItem, PolarizedCameraRayItem  # noqa: E402


def __getattr__(name):
    # the sampler lives in theia_tpu_torch.testing, which imports this
    # module; resolved lazily as theia_tpu.camera resolves it
    if name == "CameraRaySampler":
        from .testing import CameraRaySampler

        return CameraRaySampler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
