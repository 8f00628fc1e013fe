"""Bidirectional path tracer.

The port of ``theia_tpu.trace.bidirectional``: a light subpath of L
segments stores its volume vertices, then a camera subpath connects each
of its vertices to every stored light vertex in the same medium with a
visibility-tested connection weighted by 1/n(path length) (reference:
src/theia/trace.py:2098-2367, shader/tracer.bidirectional.glsl). It
misses direct and single-scatter light by construction: pair it with a
``DirectLightTracer`` (reference: trace.py:2174-2179).

A camera vertex's L x N connections are one wavefront of L * N lanes:
one ``accel.is_visible`` query (one any-hit launch on a brute-force pack)
and one record, where ``theia_tpu`` maps the query over the L light
vertices; each ray's answer is its own, so the results are equal. The
light vertices are kept as a list of each segment's tensors and stacked
once, so autograd sees no tensor written in place.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import units as u
from ..accel import is_visible
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera
from ..component import Component, TraceConfig, host_dict, resolve_device
from ..light import LightSource, SourceRay, WavelengthSource
from ..material import MaterialFlags, packed_medium_constants
from ..ops.math3d import distance, dot, local_frame, normalize
from ..polarization import unpolarized_stokes
from ..random import RNG
from ..scene import Scene, ScenePack
from .backward import _connect_stokes, _mueller_scatter, _require_frames
from .core import EventResultCode, HitItem, RayState, TracerBase, active_lanes
from .scene import _log_phase_packed, _pol_scatter_packed, scene_propagation
from .scene_backward import (
    _packed_phase, camera_ray, make_surface_interactor, onto_hit, trace_to_surface, volume_scatter,
)

__all__ = ["BidirectionalPathTracer"]


class BidirectionalPathTracer(TracerBase):
    """Bidirectional volume path tracing against a scene. Lanes and
    parameters live on ``device``: the card unless the caller names
    another."""

    name = "Bidirectional Path Tracer"
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
        callbackScope: str = "both",
        cameraMedium: str | None = None,
        lightPathLength: int = 6,
        cameraPathLength: int = 6,
        scatterCoefficient: float = float("nan"),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableTransmission: bool = False,
        disableVolumeBorder: bool = False,
        device="cuda",
    ) -> None:
        if not source.supportForward:
            raise ValueError("light source does not support forward mode")
        self.device = resolve_device(device)
        self._init_batch(batchSize, capacity)
        self.source = source
        self.camera = camera
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.scene = scene
        self.callback = EmptyEventCallback() if callback is None else callback
        self.callbackScope = callbackScope
        self.cameraMedium = cameraMedium if cameraMedium is not None else scene.medium
        self.lightPathLength = lightPathLength
        self.cameraPathLength = cameraPathLength
        self.scatterCoefficient = scatterCoefficient
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableTransmission = disableTransmission
        self.disableVolumeBorder = disableVolumeBorder

        # the reference's accounting (trace.py:2204-2214): 4 draws a
        # segment on both subpaths and the initial samples
        self.maxHitsPerThread = lightPathLength * cameraPathLength
        self.nRNGSamples = (
            wavelengthSource.nRNGSamples
            + source.nRNGForward
            + camera.nRNGSamples
            + 4 * (lightPathLength + cameraPathLength)
            + self.maxHitsPerThread * response.nRNGSamples
        )
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
        return {
            "tracer": host_dict({
                "batchSize": (self.batchSize, np.int64),
                "scatterCoefficient": (self.scatterCoefficient, np.float32),
                "maxTime": (self.maxTime, np.float32),
            }, dev),
            "scene": self.scene.pack,
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "camera": self.camera.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
        }

    def _normalize_path(self, path_length: torch.Tensor) -> torch.Tensor:
        """1/n(length): the number of estimators that cover a path of this
        length (reference: tracer.bidirectional.glsl:57-66)."""
        n = path_length - 2
        n = n - torch.clamp_min(path_length - 2 - self.cameraPathLength, 0)
        n = n - torch.clamp_min(path_length - 2 - self.lightPathLength, 0)
        return 1.0 / torch.clamp_min(n, 1).to(torch.float32)

    def _light_subpath(self, p, pack: ScenePack, prop, lam, lam_c, streams, rng):
        """The light subpath: L segments from the source, each storing the
        vertex it reaches (connectable where it is a volume vertex).
        Returns the stacked vertices (L, N, ...) and the RNG state."""
        L = self.lightPathLength
        medium = torch.full(
            streams.shape, pack.media.handle(self.scene.medium), dtype=torch.int32, device=streams.device
        )
        constants = packed_medium_constants(pack.media, medium, lam)
        src, rng = self.source.sample_forward(p["lightSource"], lam, constants, rng)
        ray = RayState(
            position=src.position,
            direction=src.direction,
            wavelength=lam,
            time=src.start_time,
            lin_contrib=src.contrib * lam_c,
            log_contrib=torch.zeros_like(lam),
            constants=constants,
        )
        alive = active_lanes(streams, p) & ~ray.is_bad()
        pol = None
        if self.polarized:
            stokes = src.stokes if src.stokes is not None else unpolarized_stokes(lam.shape, device=lam.device)
            pol = (stokes, src.pol_ref if src.pol_ref is not None else local_frame(src.direction)[0])
        interact = make_surface_interactor(
            no_r_bit=int(MaterialFlags.NO_REFLECT_FWD),
            no_t_bit=int(MaterialFlags.NO_TRANSMIT_FWD),
            eta2=False,
            disable_transmission=self.disableTransmission,
            disable_volume_border=self.disableVolumeBorder,
            pol_mode="stokes",
        )
        stokes_scatter = lambda m, d, new_dir, pol: _pol_scatter_packed(pack.media, m, d, new_dir, pol)
        verts = []
        E = EventResultCode
        for i in range(L):
            pre_alive = alive
            ray, hit, code, surf, miss, rng = trace_to_surface(pack, prop, ray, medium, pre_alive, rng)
            # the vertex the segment reaches; only volume vertices connect
            verts.append((ray.position, ray.direction, ray.time, ray.contrib, torch.where(miss, medium, -1), *(pol or ())))
            ray = onto_hit(ray, hit, surf)
            ray, medium, code2, absorbed, rng, pol = interact(pack, ray, medium, hit, surf, rng, pol)
            # the last vertex is stored, never scattered
            scatter = miss if i < L - 1 else torch.zeros_like(miss)
            ray, pol, rng = volume_scatter(pack, ray, medium, scatter, rng, pol, stokes_scatter)
            code = torch.where(surf, code2, code)
            code = torch.where(miss, int(E.RAY_SCATTERED), code)
            alive = pre_alive & (code >= 0) & ~absorbed
        return [torch.stack(field) for field in zip(*verts)], rng

    def _connect_all(self, pack: ScenePack, prop, p, verts, cray: RayState, cmedium, calive, cam_i: int, pol_c, cam):
        """Connect the camera vertex to every light vertex: the L x N pairs
        as one wavefront. Returns (HitItem of L * N lanes, their mask)."""
        v_pos, v_dir, v_time, v_contrib, v_medium, *v_pol = verts
        L, N = v_medium.shape
        same_medium = v_medium == cmedium[None]
        # observer the camera vertex, target the light vertex, as theia_tpu
        visible = is_visible(pack, cray.position.expand(L, N, 3).reshape(-1, 3), v_pos.reshape(-1, 3)).view(L, N)
        conn_dir = normalize(cray.position[None] - v_pos)  # light -> camera
        d = distance(cray.position[None], v_pos)
        # the light vertex scattered toward the camera vertex: mu_s * phase
        handles = torch.clamp_min(v_medium, 0)
        log_p_l = _log_phase_packed(pack.media, handles, dot(v_dir, conn_dir))
        mu_s = cray.constants.mu_s[None]
        light_contrib = v_contrib * mu_s * torch.exp(log_p_l)
        # the camera ray scattered toward the light vertex: mu_s * phase
        c_handles = cmedium[None].expand(L, N)
        c_dir = cray.direction[None].expand(L, N, 3)
        log_p_c = _log_phase_packed(pack.media, c_handles, dot(c_dir, -conn_dir))
        cam_factor = cray.lin_contrib[None] * torch.exp(cray.log_contrib[None]) * mu_s * torch.exp(log_p_c)
        # attenuation over the connection and the geometry term
        att = torch.exp(-cray.constants.mu_e[None] * d)
        time = v_time + cray.time[None] + d / cray.constants.vg[None]
        path_len = cam_i + torch.arange(L, dtype=torch.int32, device=d.device)[:, None] + 3
        weight = self._normalize_path(path_len)
        contrib = light_contrib * cam_factor * att * weight / torch.clamp_min(d * d, 1e-12)
        ok = same_medium & visible & calive[None] & (contrib > 0.0) & (time <= prop.max_time)
        stokes = pol_ref = None
        if pol_c is not None:
            # the light vertex's Stokes vector scattered toward the camera
            # vertex (lightsource.scatter.glsl scatterSourceRay), the camera's
            # Mueller chain extended by its connection scatter, the light
            # frame aligned to the chain's (ray.combine.glsl combineRaysAligned)
            l_stokes, l_ref = _pol_scatter_packed(pack.media, handles, v_dir, conn_dir, tuple(v_pol))
            conn_mueller, c_ref = _mueller_scatter(
                _packed_phase(pack.media, c_handles), c_dir, -conn_dir, pol_c[0][None].expand(L, N, 4, 4),
                pol_c[1][None].expand(L, N, 3),
            )
            light = SourceRay(v_pos, conn_dir, v_time, contrib, l_stokes, l_ref)
            stokes, s0 = _connect_stokes(conn_mueller, c_ref, light)
            contrib = contrib * s0
            ok = ok & (contrib > 0.0)
            stokes = stokes.reshape(-1, 4)
            pol_ref = cam.hit_pol_ref[None].expand(L, N, 3).reshape(-1, 3)
        lanes = lambda a: a[None].expand(L, *a.shape).reshape(L * N, *a.shape[1:])
        item = HitItem(
            position=lanes(cam.hit_position),
            direction=lanes(cam.hit_direction),
            normal=lanes(cam.hit_normal),
            wavelength=lanes(cray.wavelength),
            time=time.reshape(-1),
            contrib=contrib.reshape(-1),
            object_id=lanes(cam.object_id),
            stokes=stokes,
            pol_ref=pol_ref,
        )
        return item, ok.reshape(-1)

    def _trace_batch(self, p, counter, streams):
        E = EventResultCode
        pack: ScenePack = p["scene"]
        prop = scene_propagation(pack, p["tracer"])
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init(streams.device)
        cb_state = self.callback.init(
            streams.shape[0], self.lightPathLength + self.cameraPathLength + 4, streams.device
        )

        (lam, lam_c), rng = self.wavelengthSource.sample(p["photons"], rng)
        verts, rng = self._light_subpath(p, pack, prop, lam, lam_c, streams, rng)

        cam, rng = self.camera.sample_ray(p["camera"], lam, rng)
        cmedium = torch.full(
            streams.shape, pack.media.handle(self.cameraMedium), dtype=torch.int32, device=streams.device
        )
        cray = camera_ray(cam, lam, cam.contrib, packed_medium_constants(pack.media, cmedium, lam))
        calive = active_lanes(streams, p) & ~cray.is_bad()
        pol_c = None
        if self.polarized:
            _require_frames(self, cam)
            pol_c = (cam.mueller, cam.pol_ref)
        interact = make_surface_interactor(
            disable_transmission=self.disableTransmission, disable_volume_border=self.disableVolumeBorder
        )
        mueller_scatter = lambda m, d, new_dir, pol: _mueller_scatter(_packed_phase(pack.media, m), d, new_dir, *pol)
        for i in range(self.cameraPathLength):
            pre_alive = calive
            cray, hit, code, surf, miss, rng = trace_to_surface(pack, prop, cray, cmedium, pre_alive, rng)
            # connect this camera vertex to the light subpath, at volume and
            # surface vertices alike (tracer.bidirectional.glsl:225-233)
            conn_ok = pre_alive & (code >= 0)
            conn = replace(cray, lin_contrib=torch.where(conn_ok, cray.lin_contrib, 0.0))
            item, ok = self._connect_all(pack, prop, p, verts, conn, cmedium, calive, i, pol_c, cam)
            resp_state, rng = self.response.record(p["response"], resp_state, item, ok, rng)

            cray = onto_hit(cray, hit, surf)
            cray, cmedium, code2, absorbed, rng, pol_c = interact(pack, cray, cmedium, hit, surf, rng, pol_c)
            cray, pol_c, rng = volume_scatter(pack, cray, cmedium, miss, rng, pol_c, mueller_scatter)
            code = torch.where(surf, code2, code)
            code = torch.where(miss, int(E.RAY_SCATTERED), code)
            calive = pre_alive & (code >= 0) & ~absorbed
        if self._debug_rng:
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state
