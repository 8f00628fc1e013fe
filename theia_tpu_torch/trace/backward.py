"""Backward (camera-origin) volume tracing and the direct-light connection.

The port of ``theia_tpu.trace.backward``. ``VolumeBackwardTracer``:
camera rays scatter through one medium; at every scatter vertex the light
source is sampled backward and connected with a shadow ray (reference:
src/theia/trace.py:773-1045, shader/tracer.volume.backward.glsl,
shader/ray.combine.glsl). ``sample_direct``: the zero-scatter connection
of a camera point and a backward light sample, which
``DirectLightTracer`` shares (reference: shader/tracer.direct.common.glsl).
Every lane's RNG dims advance only where ``theia_tpu``'s do, so the same
streams give the same paths.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import units as u
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera
from ..component import Component, TraceConfig, host_dict, resolve_device
from ..light import LightSource, WavelengthSource
from ..lookup import lookup
from ..material import Medium, medium_constants
from ..ops.math3d import distance, dot, local_frame, sqrt
from ..ops.sampling import scatter_dir
from ..ops.table_read import PHASE
from ..polarization import (
    apply_rotation,
    phase_matrix_elements,
    phase_mueller,
    rotate_pol_ref,
    rotation_coeffs,
    rotation_mueller,
    unpolarized_stokes,
)
from ..random import RNG, RNGState
from ..target import Target
from .core import (
    EventResultCode,
    HitItem,
    PropagateParams,
    RayState,
    TracerBase,
    active_lanes,
    merge_dim,
    propagate_ray,
    reattach_geometry,
    sample_scatter_dir_medium,
    sample_scatter_length,
    scatter_ray,
    scatter_ray_is,
    select_ray,
    update_ray,
    update_ray_is,
)

__all__ = ["VolumeBackwardTracer", "combine_rays_aligned", "sample_direct"]


def _light_pol(light):
    """Stokes vector and frame of a backward light sample; unpolarized by
    default (reference: lightsource.common.glsl createSourceRay)."""
    stokes = light.stokes
    if stokes is None:
        stokes = unpolarized_stokes(light.contrib.shape, device=light.contrib.device)
    pol_ref = light.pol_ref if light.pol_ref is not None else local_frame(light.direction)[0]
    return stokes, pol_ref


def _mueller_scatter(phase_matrix, direction, new_dir, mueller, pol_ref):
    """Backward scatter: mueller <- mueller @ rotation^T @ phase, where
    ``phase_matrix(cos_theta)`` gives the medium's (m12, m22, m33, m34): a
    volume medium's (``phase_matrix_elements``) or a packed store's by
    handle (``trace.scene._phase_matrix_packed``) (reference:
    ray.scatter.glsl _scatterPolRay_impl, backward)."""
    m12, m22, m33, m34 = phase_matrix(dot(direction, new_dir))
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, new_dir)
    rot_t = rotation_mueller(c, s).transpose(-1, -2)
    return mueller @ rot_t @ phase_mueller(m12, m22, m33, m34), new_ref


def _connect_stokes(mueller, pol_ref, light):
    """The light's Stokes vector carried through the Mueller chain; returns
    (Stokes vector over S0, S0) (reference: ray.combine.glsl
    combineRaysAligned, polarized)."""
    l_stokes, l_ref = _light_pol(light)
    c, s = rotation_coeffs(light.direction, l_ref, pol_ref)
    stokes = (mueller @ apply_rotation(l_stokes, c, s)[..., None])[..., 0]
    s0 = stokes[..., 0]
    # a zero-intensity lane stays finite: its 0/0 would poison every gradient
    safe = torch.where(torch.abs(s0) > 1e-30, s0, 1.0)
    return stokes / safe[..., None], s0


def combine_rays_aligned(ray: RayState, end_pos, end_contrib, end_time_offset, prop: PropagateParams):
    """Attenuate the ray over the connection and combine the contributions
    (reference: shader/ray.combine.glsl:109-143); returns (contrib, time,
    ok). The connection's length is geometry, not a sample: its gradient
    is re-attached."""
    dist = distance(ray.position, end_pos)
    ray, code = update_ray(ray, dist, prop)
    ray = reattach_geometry(ray, dist)
    contrib = end_contrib * ray.contrib
    time = end_time_offset + ray.time
    ok = (code >= 0) & (time <= prop.max_time) & (contrib > 0.0)
    return contrib, time, ok


def _require_frames(tracer, cam) -> None:
    if cam.mueller is None:
        raise ValueError(f"camera {type(tracer.camera).__name__} does not provide polarization frames")


def sample_direct(tracer, p, prop, medium, resp_state, cb_state, rng: RNGState, occluder=None):
    """The zero-scatter connection (reference:
    shader/tracer.direct.common.glsl:55-90); ``occluder(a, b)`` is True
    where a and b see each other. Returns (resp_state, cb_state, rng)."""
    E = EventResultCode
    streams = rng.stream
    (lam, lam_c), rng = tracer.wavelengthSource.sample(p["photons"], rng)
    cam_pt, rng = tracer.camera.sample_point(p["camera"], lam, rng)
    constants = medium_constants(medium, lam)
    light, rng = tracer.source.sample_backward(
        p["lightSource"], cam_pt.position, cam_pt.normal, lam, constants, rng
    )
    ray = RayState(
        position=light.position,
        direction=light.direction,
        wavelength=lam,
        time=light.start_time,
        lin_contrib=light.contrib * lam_c,
        log_contrib=torch.zeros_like(lam),
        constants=constants,
    )
    lane = active_lanes(streams, p)
    cb_state = tracer.callback.on_event(
        p["callback"], cb_state, ray, torch.full_like(streams, int(E.RAY_CREATED)), lane, 0
    )
    # the light must come from the front side and be visible
    ok = lane & (dot(cam_pt.normal, light.direction) < 0.0)
    if occluder is not None:
        ok = ok & occluder(cam_pt.position, light.position)
    cam_ray = tracer.camera.ray_from_point(p["camera"], cam_pt, light.direction, lam)
    contrib, time, c_ok = combine_rays_aligned(ray, cam_ray.position, cam_ray.contrib, cam_ray.time_delta, prop)
    ok = ok & c_ok
    stokes = hit_pol_ref = None
    if tracer.polarized:
        _require_frames(tracer, cam_ray)
        stokes, s0 = _connect_stokes(cam_ray.mueller, cam_ray.pol_ref, light)
        contrib = contrib * s0
        ok = ok & (contrib > 0.0)
        hit_pol_ref = cam_ray.hit_pol_ref
    item = HitItem(
        position=cam_ray.hit_position,
        direction=cam_ray.hit_direction,
        normal=cam_ray.hit_normal,
        wavelength=lam,
        time=time,
        contrib=contrib,
        object_id=cam_ray.object_id,
        stokes=stokes,
        pol_ref=hit_pol_ref,
    )
    rng_b = rng
    resp_state, rng = tracer.response.record(p["response"], resp_state, item, ok, rng)
    rng = merge_dim(rng, rng_b, ok)
    code = torch.where(ok, int(E.RAY_DETECTED), int(E.RAY_MISSED)).to(torch.int32)
    cb_state = tracer.callback.on_event(p["callback"], cb_state, ray, code, lane, 1)
    return resp_state, cb_state, rng


class VolumeBackwardTracer(TracerBase):
    """Camera-origin volume path tracing with a light connection at every
    vertex (reference: src/theia/trace.py:773-1045). Lanes and parameters
    live on ``device``: the card unless the caller names another."""

    name = "Volume Backward Tracer"
    _param_names = ("scatterCoefficient", "maxTime")
    _extra_names = ("medium", "traceBBox")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response,
        rng: RNG,
        *,
        medium: Medium | None,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        nScattering: int = 6,
        target: Target | None = None,
        scatterCoefficient: float = float("nan"),
        traceBBox: tuple = ((-1.0 * u.km,) * 3, (1.0 * u.km,) * 3),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
        device="cuda",
    ) -> None:
        if not source.supportBackward:
            raise ValueError("Light source does not support backward mode!")
        if not disableDirectLighting and not camera.supportDirect:
            raise ValueError("Camera does not support direct mode!")
        self.device = resolve_device(device)
        self._init_batch(batchSize, capacity)
        self.source = source
        self.camera = camera
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.medium = medium
        self.callback = EmptyEventCallback() if callback is None else callback
        self.nScattering = nScattering
        self.target = target
        self.scatterCoefficient = scatterCoefficient
        self.traceBBox = traceBBox
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting

        # the reference's accounting (src/theia/trace.py:895-910)
        self.maxHitsPerThread = nScattering + (0 if disableDirectLighting else 1)
        rngStride = 3 + source.nRNGBackward
        rngPre = wavelengthSource.nRNGSamples + camera.nRNGSamples
        if not disableDirectLighting:
            rngPre += wavelengthSource.nRNGSamples + camera.nRNGDirect + source.nRNGBackward
        self.nRNGSamples = rngPre + rngStride * nScattering + self.maxHitsPerThread * response.nRNGSamples
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=self.maxHitsPerThread,
                normalization=self.normalization,
                polarized=polarized,
            )
        )

    def collectStages(self) -> list[tuple[str, Component]]:
        stages = [("photons", self.wavelengthSource), ("lightSource", self.source), ("camera", self.camera)]
        if self.target is not None:
            stages.append(("target", self.target))
        return stages + [("tracer", self), ("callback", self.callback), ("response", self.response)]

    def params(self):
        dev = self.device
        p = {
            "tracer": host_dict({
                "batchSize": (self.batchSize, np.int64),
                "scatterCoefficient": (self.scatterCoefficient, np.float32),
                "maxTime": (self.maxTime, np.float32),
                "lowerBBox": (self.traceBBox[0], np.float32),
                "upperBBox": (self.traceBBox[1], np.float32),
            }, dev),
            "medium": None if self.medium is None else self.medium.to(dev),
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "camera": self.camera.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
        }
        if self.target is not None:
            p["target"] = self.target.params(dev)
        return p

    def _propagation(self, p) -> PropagateParams:
        lo, hi = p["tracer"]["lowerBBox"], p["tracer"]["upperBBox"]
        extent = hi - lo
        return PropagateParams(
            scatter_coefficient=p["tracer"]["scatterCoefficient"],
            lower_bbox=lo,
            upper_bbox=hi,
            max_time=p["tracer"]["maxTime"],
            max_dist=sqrt(dot(extent, extent)),
        )

    def _visible(self, p, observer, target_pos):
        """Self-shadowing against the optional target
        (reference: tracer.volume.backward.glsl:45-60)."""
        if self.target is None:
            return torch.ones(observer.shape[:-1], dtype=torch.bool, device=observer.device)
        d = target_pos - observer
        dist = sqrt(torch.clamp_min(dot(d, d), 1e-30))
        hit = self.target.intersect(p["target"], observer, d / dist[..., None])
        return ~hit.valid | (hit.dist >= dist)

    def _trace_batch(self, p, counter, streams):
        E = EventResultCode
        medium = p["medium"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init(streams.device)
        cb_state = self.callback.init(streams.shape[0], self.nScattering + 4, streams.device)

        i_path = 0
        if not self.disableDirectLighting:
            resp_state, cb_state, rng = sample_direct(self, p, prop, medium, resp_state, cb_state, rng)
            i_path = 2

        # the camera ray
        (lam, lam_c), rng = self.wavelengthSource.sample(p["photons"], rng)
        cam, rng = self.camera.sample_ray(p["camera"], lam, rng)
        pol = None
        if self.polarized:
            _require_frames(self, cam)
            pol = (cam.mueller, cam.pol_ref)
            volume_phase = lambda cos_theta: phase_matrix_elements(medium, cos_theta)
        ray = RayState(
            position=cam.position,
            direction=cam.direction,
            wavelength=lam,
            time=cam.time_delta,
            lin_contrib=cam.contrib * lam_c,
            log_contrib=torch.zeros_like(lam),
            constants=medium_constants(medium, lam),
        )
        alive = active_lanes(streams, p) & ~ray.is_bad()
        event = lambda state, code, mask, i: self.callback.on_event(p["callback"], state, ray, code, mask, i)
        cb_state = event(cb_state, torch.full_like(streams, int(E.RAY_CREATED)), alive, i_path)
        i_path += 1

        # the reference's loop runs PATH_LENGTH - 1 times: the light
        # connections already extend every path by one segment
        for i in range(self.nScattering - 1):
            pre_alive = alive
            # trace (tracer.volume.backward.glsl:86-115)
            uu, rng = rng.uniform()
            dist = sample_scatter_length(ray, prop, uu)
            if self.target is not None:
                hit = self.target.intersect(p["target"], ray.position, ray.direction)
                shadowed = hit.valid & (hit.dist <= dist)
                dist = torch.where(shadowed, hit.dist, dist)
            else:
                shadowed = torch.zeros_like(alive)
            ray, code = propagate_ray(ray, dist, prop)
            ray = update_ray_is(ray, dist, prop, shadowed)
            code = torch.where(shadowed, int(E.RAY_ABSORBED), code).to(torch.int32)
            step_ok = pre_alive & ~shadowed & (code >= 0)

            # the shadow ray: connect the scatter vertex to the light
            rng_b = rng
            light, rng = self.source.sample_backward(
                p["lightSource"], ray.position, torch.zeros_like(ray.position), ray.wavelength, ray.constants, rng
            )
            visible = self._visible(p, light.position, ray.position)
            conn = scatter_ray(ray, medium, -light.direction)
            contrib, time, ok = combine_rays_aligned(conn, light.position, light.contrib, light.start_time, prop)
            ok = ok & step_ok & visible
            stokes = hit_pol_ref = None
            if pol is not None:
                # extend the Mueller chain by the connection's scatter, then
                # carry the light's Stokes vector through it
                conn_mueller, conn_ref = _mueller_scatter(volume_phase, ray.direction, -light.direction, *pol)
                stokes, s0 = _connect_stokes(conn_mueller, conn_ref, light)
                contrib = contrib * s0
                ok = ok & (contrib > 0.0)
                hit_pol_ref = cam.hit_pol_ref
            item = HitItem(
                position=cam.hit_position,
                direction=cam.hit_direction,
                normal=cam.hit_normal,
                wavelength=ray.wavelength,
                time=time,
                contrib=contrib,
                object_id=cam.object_id,
                stokes=stokes,
                pol_ref=hit_pol_ref,
            )
            resp_state, rng = self.response.record(p["response"], resp_state, item, ok, rng)
            rng = merge_dim(rng, rng_b, step_ok)

            code = torch.where(step_ok, int(E.RAY_SCATTERED), code).to(torch.int32)
            alive = pre_alive & step_ok
            cb_state = event(cb_state, code, pre_alive, i_path + i)

            # scatter for the next segment (none after the last)
            rng_b = rng
            (u1, u2), rng = rng.uniform2d()
            cos_theta, phi, _ = sample_scatter_dir_medium(medium, ray.direction, ray.wavelength, u1, u2)
            cos_theta = cos_theta.detach()
            new_dir = scatter_dir(ray.direction, cos_theta, phi)
            scattered = scatter_ray_is(ray, new_dir)
            if medium is not None and medium.log_phase_function is not None:
                log_p = lookup(medium.log_phase_function, cos_theta, affine=PHASE)
                scattered = replace(scattered, log_contrib=scattered.log_contrib + log_p - log_p.detach())
            do_scatter = alive & (i < self.nScattering - 2)
            if pol is not None:
                new_mueller, new_ref = _mueller_scatter(volume_phase, ray.direction, new_dir, *pol)
                pol = (
                    torch.where(do_scatter[..., None, None], new_mueller, pol[0]),
                    torch.where(do_scatter[..., None], new_ref, pol[1]),
                )
            ray = select_ray(do_scatter, scattered, ray)
            rng = merge_dim(rng, rng_b, do_scatter)

        cb_state = event(
            cb_state, torch.full_like(streams, int(E.MAX_ITER)), alive, i_path + self.nScattering - 1
        )
        if self._debug_rng:
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state
