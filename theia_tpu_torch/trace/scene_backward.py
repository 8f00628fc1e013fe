"""Camera-origin scene tracers.

The port of ``theia_tpu.trace.scene_backward``.
``SceneBackwardTargetTracer``: camera rays traced through the scene with
the forward tracer's segment and the backward flags; hits on geometry
flagged LIGHT_SOURCE respond, an in-scene detector seen without a light
model (reference: src/theia/trace.py:1605-1880,
shader/tracer.scene.backward.target.glsl). ``SceneBackwardTracer``:
camera rays scatter through the scene and every volume vertex is
connected to the light with a shadow ray through ``accel.is_visible``
(reference: src/theia/trace.py:1339-1602, shader/tracer.scene.backward.glsl,
shader/scene.traverse.backward.glsl). :func:`make_surface_interactor` is
the Fresnel surface interaction of either transport direction, which
``trace.bidirectional`` shares. Every lane's RNG dims advance only where
``theia_tpu``'s do. The queries, the table reads, the draws and the
histogram record are the hand-written kernels on a CUDA device.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import units as u
from ..accel import intersect_scene, is_visible, offset_ray
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera
from ..component import Component, TraceConfig, resolve_device
from ..light import LightSource, WavelengthSource
from ..material import MaterialFlags, MediumConstants, packed_medium_constants
from ..ops.math3d import dot
from ..ops.sampling import scatter_dir
from ..polarization import apply_polarizer, polarizer_coeffs, polarizer_mueller, rotate_pol_ref, rotation_mueller
from ..random import RNG
from ..scene import Scene, ScenePack
from ..target import TargetGuide
from .backward import _connect_stokes, _mueller_scatter, _require_frames, combine_rays_aligned, sample_direct
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
    sample_scatter_length,
    update_ray_is,
)
from .scene import (
    SceneForwardTracer,
    _fresnel,
    _log_phase_packed,
    _phase_matrix_packed,
    _pol_align,
    _reflect,
    _refract,
    _sample_cos_packed,
    scene_propagation,
)

__all__ = ["SceneBackwardTargetTracer", "SceneBackwardTracer", "make_surface_interactor"]

_BLACK = int(MaterialFlags.BLACK_BODY)
_VOLUME = int(MaterialFlags.VOLUME_BORDER)


class SceneBackwardTargetTracer(SceneForwardTracer):
    """Camera-origin tracing that detects LIGHT_SOURCE-flagged geometry:
    the forward tracer's segment with the backward flags and eta^2 on
    transmission. Unpolarized only, as in ``theia_tpu``."""

    name = "Scene Backward Target Tracer"
    _target_bit = int(MaterialFlags.LIGHT_SOURCE)
    _no_r_bit = int(MaterialFlags.NO_REFLECT_BWD)
    _no_t_bit = int(MaterialFlags.NO_TRANSMIT_BWD)
    _transmit_eta2 = True

    def __init__(
        self,
        batchSize: int,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response,
        rng: RNG,
        scene: Scene,
        *,
        medium: str | None = None,
        maxPathLength: int = 6,
        targetId: int = -1,
        targetGuide: TargetGuide | None = None,
        device="cuda",
        **kwargs,
    ) -> None:
        self.camera = camera
        kwargs.pop("disableDirectLighting", None)
        if kwargs.get("polarized"):
            raise NotImplementedError("polarized backward scene tracing (Mueller transport) is not yet supported")
        # the reference's accounting (trace.py:1729-1738); there is no
        # direct-light prologue, the flag only keeps the first response on
        super().__init__(
            batchSize,
            _CameraAsSource(camera),
            wavelengthSource,
            response,
            rng,
            scene,
            maxPathLength=maxPathLength,
            targetId=targetId,
            targetGuide=targetGuide,
            sourceMedium=medium,
            disableDirectLighting=False,
            device=device,
            **kwargs,
        )

    def _sample_initial(self, p, pack, streams, rng):
        (lam, lam_contrib), rng = self.wavelengthSource.sample(p["photons"], rng)
        cam, rng = self.camera.sample_ray(p["camera"], lam, rng)
        medium = torch.full(
            streams.shape, pack.media.handle(self.sourceMedium), dtype=torch.int32, device=streams.device
        )
        ray = camera_ray(cam, lam, cam.contrib * lam_contrib, packed_medium_constants(pack.media, medium, lam))
        return ray, medium, None, rng

    def params(self):
        p = super().params()
        p["camera"] = self.camera.params(self.device)
        return p

    def collectStages(self) -> list[tuple[str, Component]]:
        stages = [("photons", self.wavelengthSource), ("camera", self.camera)]
        if self.targetGuide is not None:
            stages.append(("guide", self.targetGuide))
        return stages + [("tracer", self), ("callback", self.callback), ("response", self.response)]


class _CameraAsSource:
    """Stands in for the forward tracer's source: its draws are the
    camera's, and ``_sample_initial`` samples the camera instead."""

    supportForward = True

    def __init__(self, camera: Camera) -> None:
        self.nRNGForward = camera.nRNGSamples

    def params(self, device):
        return {}


def _sample_phase(pack: ScenePack, medium, direction, u1, u2):
    """Importance sample the packed phase function: the new direction, the
    phase function's value and its log at the sampled (detached) cosine,
    log(1/4pi) where a medium has no table (``theia_tpu``'s
    ``scene_backward._sample_phase``; the forward tracer's
    ``_sample_phase_packed`` reads it at the new direction's cosine)."""
    cos_theta, _ = _sample_cos_packed(pack, medium, u2)
    new_dir = scatter_dir(direction, cos_theta, 2.0 * np.pi * u1)
    log_p = _log_phase_packed(pack.media, medium, cos_theta)
    return new_dir, torch.exp(log_p), log_p


def _packed_phase(store, handle):
    """``_mueller_scatter``'s phase matrix from a packed store by handle."""
    return lambda cos_theta: _phase_matrix_packed(store, handle, cos_theta)


def make_surface_interactor(
    *,
    no_r_bit: int = int(MaterialFlags.NO_REFLECT_BWD),
    no_t_bit: int = int(MaterialFlags.NO_TRANSMIT_BWD),
    eta2: bool = True,
    disable_transmission: bool = False,
    disable_volume_border: bool = False,
    pol_mode: str = "mueller",
):
    """The surface interaction (Fresnel reflect/transmit importance
    sampling) of one transport direction: the backward flags with eta^2 on
    transmission (a camera ray's radiance), or the forward flags without
    it (a light subpath). ``pol_mode``: ``"mueller"`` extends a camera
    ray's Mueller chain, ``"stokes"`` carries a light ray's Stokes vector
    (reference: scene.traverse.backward.glsl:19-89, scene.traverse.glsl:73-154).

    Returns ``interact(pack, ray, medium, hit, surf, rng, pol=None)`` ->
    (ray, medium, code, absorbed, rng, pol)."""

    def interact(pack: ScenePack, ray: RayState, medium, hit, surf, rng, pol=None):
        flags = hit.flags
        no = torch.zeros_like(surf)
        is_abs = (flags & _BLACK) != 0
        vol_border = no if disable_volume_border else (flags & _VOLUME) != 0
        can_reflect = (flags & no_r_bit) == 0
        can_transmit = no if disable_transmission else (flags & no_t_bit) == 0

        n_i, n_t, r_s, r_p = _fresnel(pack, ray, hit)
        r_coef = 0.5 * (r_s * r_s + r_p * r_p)
        u_surf, rng_a = rng.uniform()
        both = surf & ~is_abs & ~vol_border & can_reflect & can_transmit
        rng = merge_dim(rng_a, rng, both)
        do_reflect = torch.where(both, u_surf < r_coef.detach(), can_reflect)
        absorbed = surf & (is_abs | (~can_reflect & ~can_transmit & ~vol_border))

        eta = n_i / n_t
        refl_dir = _reflect(ray.direction, hit.ray_nrm)
        refl_pos = offset_ray(hit.world_pos, hit.ray_nrm)
        # the refracted direction is sampler state: the index's gradient
        # flows through the factors, not the geometry
        trans_dir = _refract(ray.direction, hit.ray_nrm, eta.detach())
        trans_pos = offset_ray(hit.world_pos, -hit.ray_nrm)
        refl_factor = torch.where(both, 1.0, r_coef)
        trans_factor = torch.where(both, 1.0, 1.0 - r_coef)
        if eta2:
            trans_factor = trans_factor * eta * eta

        kept = surf & ~is_abs & ~vol_border
        sel_r = kept & do_reflect & can_reflect
        sel_t = kept & ~do_reflect & can_transmit
        if pol is not None:
            # align to the plane of incidence, then the taken branch's
            # Fresnel polarizer (reference: ray.propagate.glsl alignRayToHit,
            # ray.surface.glsl)
            _, m12_r, m33_r = polarizer_coeffs(r_p, r_s)
            _, m12_t, m33_t = polarizer_coeffs((r_p + 1.0) * eta, r_s + 1.0)
            if pol_mode == "mueller":
                mueller, pol_ref = pol
                a_ref, c, s = rotate_pol_ref(ray.direction, pol_ref, hit.ray_nrm)
                mueller = torch.where(surf[..., None, None], mueller @ rotation_mueller(c, s).transpose(-1, -2), mueller)
                pol_ref = torch.where(surf[..., None], a_ref, pol_ref)
                mueller = torch.where(
                    sel_r[..., None, None], mueller @ polarizer_mueller(m12_r, m33_r),
                    torch.where(sel_t[..., None, None], mueller @ polarizer_mueller(m12_t, m33_t), mueller),
                )
                pol = (mueller, pol_ref)
            else:
                stokes, pol_ref = _pol_align(ray.direction, pol, hit.ray_nrm)
                stokes = torch.where(surf[..., None], stokes, pol[0])
                pol_ref = torch.where(surf[..., None], pol_ref, pol[1])
                stokes = torch.where(
                    sel_r[..., None], apply_polarizer(stokes, m12_r, m33_r),
                    torch.where(sel_t[..., None], apply_polarizer(stokes, m12_t, m33_t), stokes),
                )
                pol = (stokes, pol_ref)
        new_medium = torch.where(surf & (vol_border | sel_t), hit.medium_tr, medium)
        crossed = new_medium != medium
        new_dir = torch.where(sel_r[..., None], refl_dir, torch.where(sel_t[..., None], trans_dir, ray.direction))
        new_pos = torch.where(
            sel_r[..., None], refl_pos, torch.where((sel_t | (surf & vol_border))[..., None], trans_pos, ray.position)
        )
        new_lin = torch.where(
            sel_r, ray.lin_contrib * refl_factor, torch.where(sel_t, ray.lin_contrib * trans_factor, ray.lin_contrib)
        )
        new_c, old_c = packed_medium_constants(pack.media, new_medium, ray.wavelength), ray.constants
        ray = RayState(
            position=new_pos,
            direction=new_dir,
            wavelength=ray.wavelength,
            time=ray.time,
            lin_contrib=new_lin,
            log_contrib=ray.log_contrib,
            constants=MediumConstants(
                *(torch.where(crossed, getattr(new_c, f), getattr(old_c, f)) for f in ("n", "vg", "mu_s", "mu_e"))
            ),
        )
        E = EventResultCode
        code = torch.where(surf & vol_border, int(E.VOLUME_HIT), int(E.RAY_HIT))
        code = torch.where(absorbed, int(E.RAY_ABSORBED), code).to(torch.int32)
        return ray, new_medium, code, absorbed, rng, pol

    return interact


def camera_ray(cam, lam, lin_contrib, constants) -> RayState:
    """A camera ray's state at its start."""
    return RayState(
        position=cam.position,
        direction=cam.direction,
        wavelength=lam,
        time=cam.time_delta,
        lin_contrib=lin_contrib,
        log_contrib=torch.zeros_like(lam),
        constants=constants,
    )


def volume_scatter(pack: ScenePack, ray: RayState, medium, miss, rng, pol=None, pol_scatter=None):
    """Scatter the lanes of ``miss`` into a phase-sampled direction (the
    phase function's gradient through its log, its value cancelled by the
    pdf); ``pol_scatter(medium, direction, new_dir, pol)`` carries the
    polarization state. The RNG dims advance on ``miss`` alone. Returns
    (ray, pol, rng)."""
    rng_b = rng
    (s1, s2), rng = rng.uniform2d()
    new_dir, _, log_p = _sample_phase(pack, medium, ray.direction, s1, s2)
    if pol is not None:
        new_pol = pol_scatter(medium, ray.direction, new_dir, pol)
        pol = tuple(torch.where(miss.reshape(miss.shape + (1,) * (a.dim() - 1)), a, b) for a, b in zip(new_pol, pol))
    ray = replace(
        ray,
        direction=torch.where(miss[..., None], new_dir, ray.direction),
        lin_contrib=torch.where(miss, ray.lin_contrib * ray.constants.mu_s, ray.lin_contrib),
        log_contrib=torch.where(miss, ray.log_contrib + log_p - log_p.detach(), ray.log_contrib),
    )
    return ray, pol, merge_dim(rng, rng_b, miss)


def trace_to_surface(pack: ScenePack, prop: PropagateParams, ray: RayState, medium, pre_alive, rng):
    """One segment's distance sample, scene query and propagation: the
    sampled distance or the nearest hit before it, whose geometric length
    keeps its gradient. Returns (ray, hit, code, surf, miss, rng); the
    caller puts ``surf`` lanes on the hit (:func:`onto_hit`)."""
    uu, rng = rng.uniform()
    dist = sample_scatter_length(ray, prop, uu)
    hit = intersect_scene(pack, medium, ray.position, ray.direction, dist)
    travel = torch.where(hit.valid, hit.t, dist)
    ray, code = propagate_ray(ray, travel, prop)
    ray = reattach_geometry(ray, travel, valid=hit.valid)
    ray = update_ray_is(ray, travel, prop, hit.valid)
    code = torch.where(hit.valid & (hit.error != 0), hit.error, code)
    in_bounds = code >= 0
    surf = pre_alive & in_bounds & hit.valid
    miss = pre_alive & in_bounds & ~hit.valid
    return ray, hit, code, surf, miss, rng


def onto_hit(ray: RayState, hit, surf) -> RayState:
    """``surf`` lanes moved onto their hit's world position."""
    return replace(ray, position=torch.where(surf[..., None], hit.world_pos, ray.position))


class SceneBackwardTracer(TracerBase):
    """Camera-origin scene tracing with a light connection at every volume
    vertex (reference: src/theia/trace.py:1339-1602). Lanes and parameters
    live on ``device``: the card unless the caller names another."""

    name = "Scene Backward Tracer"
    _param_names = ("scatterCoefficient", "maxTime")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response,
        rng: RNG,
        scene: Scene,
        *,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        medium: str | None = None,
        maxPathLength: int = 6,
        scatterCoefficient: float = float("nan"),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
        disableTransmission: bool = False,
        disableVolumeBorder: bool = False,
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
        self.scene = scene
        self.callback = EmptyEventCallback() if callback is None else callback
        self.camMedium = medium if medium is not None else scene.medium
        self.maxPathLength = maxPathLength
        self.scatterCoefficient = scatterCoefficient
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting
        self.disableTransmission = disableTransmission
        self.disableVolumeBorder = disableVolumeBorder

        # the reference's accounting (trace.py:1459-1471)
        maxHits = maxPathLength + (0 if disableDirectLighting else 1)
        self.maxHitsPerThread = maxHits
        rngStride = 3 + source.nRNGBackward
        rngPre = wavelengthSource.nRNGSamples + camera.nRNGSamples
        if not disableDirectLighting:
            rngPre += wavelengthSource.nRNGSamples + camera.nRNGDirect + source.nRNGBackward
        self.nRNGSamples = rngPre + rngStride * maxPathLength + maxHits * response.nRNGSamples
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=maxHits,
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
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return {
            "tracer": {
                "batchSize": torch.tensor(self.batchSize, dtype=torch.int64, device=dev),
                "scatterCoefficient": f32(self.scatterCoefficient),
                "maxTime": f32(self.maxTime),
            },
            "scene": self.scene.pack,
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "camera": self.camera.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
            # the camera's medium on its own, for the direct connection
            "camMedium": self.scene.materials.media.medium(self.camMedium) if self.camMedium else None,
        }

    def _trace_batch(self, p, counter, streams):
        E = EventResultCode
        pack: ScenePack = p["scene"]
        prop = scene_propagation(pack, p["tracer"])
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init(streams.device)
        cb_state = self.callback.init(streams.shape[0], self.maxPathLength + 4, streams.device)

        i_path = 0
        if not self.disableDirectLighting:
            resp_state, cb_state, rng = sample_direct(
                self, p, prop, p["camMedium"], resp_state, cb_state, rng,
                occluder=lambda a, b: is_visible(pack, a, b),
            )
            i_path = 2

        (lam, lam_c), rng = self.wavelengthSource.sample(p["photons"], rng)
        cam, rng = self.camera.sample_ray(p["camera"], lam, rng)
        pol = None
        if self.polarized:
            _require_frames(self, cam)
            pol = (cam.mueller, cam.pol_ref)
        medium = torch.full(
            streams.shape, pack.media.handle(self.camMedium), dtype=torch.int32, device=streams.device
        )
        ray = camera_ray(cam, lam, cam.contrib * lam_c, packed_medium_constants(pack.media, medium, lam))
        alive = active_lanes(streams, p) & ~ray.is_bad()
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, torch.full_like(streams, int(E.RAY_CREATED)), alive, i_path
        )
        i_path += 1
        interact = make_surface_interactor(
            disable_transmission=self.disableTransmission, disable_volume_border=self.disableVolumeBorder
        )
        mueller_scatter = lambda m, d, new_dir, pol: _mueller_scatter(_packed_phase(pack.media, m), d, new_dir, *pol)

        # the reference's loop runs PATH_LENGTH - 1 times: the light
        # connections already extend every path by one segment
        for i in range(self.maxPathLength - 1):
            alive = alive & ~ray.is_bad()
            pre_alive = alive
            ray, hit, code, surf, miss, rng = trace_to_surface(pack, prop, ray, medium, pre_alive, rng)
            ray = onto_hit(ray, hit, surf)
            ray, medium, code2, absorbed_surf, rng, pol = interact(pack, ray, medium, hit, surf, rng, pol)

            # the shadow ray at volume vertices: drawn on every lane, its
            # dims kept on misses alone
            rng_b = rng
            light, rng = self.source.sample_backward(
                p["lightSource"], ray.position, torch.zeros_like(ray.position), ray.wavelength, ray.constants, rng
            )
            visible = is_visible(pack, light.position, ray.position)
            # scatter the connection toward the light: mu_s and the phase
            # function at the connection's cosine
            log_p = _log_phase_packed(pack.media, medium, dot(ray.direction, -light.direction))
            conn = replace(
                ray,
                direction=-light.direction,
                lin_contrib=ray.lin_contrib * ray.constants.mu_s,
                log_contrib=ray.log_contrib + log_p,
            )
            contrib, time, ok = combine_rays_aligned(conn, light.position, light.contrib, light.start_time, prop)
            ok = ok & miss & visible
            stokes = hit_pol_ref = None
            if pol is not None:
                conn_mueller, conn_ref = mueller_scatter(medium, ray.direction, -light.direction, pol)
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
            rng = merge_dim(rng, rng_b, miss)

            ray, pol, rng = volume_scatter(pack, ray, medium, miss, rng, pol, mueller_scatter)
            code = torch.where(surf, code2, code)
            code = torch.where(miss, int(E.RAY_SCATTERED), code).to(torch.int32)
            alive = pre_alive & (code >= 0) & ~absorbed_surf
            cb_state = self.callback.on_event(p["callback"], cb_state, ray, code, pre_alive, i_path + i)

        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, torch.full_like(streams, int(E.MAX_ITER)), alive,
            i_path + self.maxPathLength - 1,
        )
        if self._debug_rng:
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state
