"""Scene forward tracer: full geometry with Fresnel media boundaries.

The port of ``theia_tpu.trace.scene.SceneForwardTracer``, unpolarized or
polarized (a Stokes vector and its reference frame ride with each ray),
guided by a target guide or not. Per segment: exponential distance
sampling, the target-guide free-shadow-ray extension, scene intersection
with media-mismatch checks, surface interaction (Fresnel reflect/
transmit/volume-border/black-body by material flags) or volume scatter
with guide MIS (reference: src/theia/trace.py:1048-1336,
shader/tracer.scene.forward.glsl, shader/scene.traverse.glsl).

The responses fuse exactly where ``theia_tpu`` fuses them by default:
with a guide, a response that draws no random numbers and no
polarization, the free-extension shadow response rides on the main
surface record and the two MIS shadow rays go through one record.
Otherwise every record is its own call in the reference's order, so a
response that draws (``StoreTimeHitResponse``) draws in ``theia_tpu``'s
order. Either way the two MIS shadow rays share one 2N-lane query. The
final segment is peeled: it never scatters, so it skips the MIS shadow
and scatter blocks. ``ScenePhotonTracer`` (``trace.photon``) runs this
tracer in photon mode (``_photon_mode``).

Two routes run a batch (``segment_route``). The flagship's configuration
without autograd takes ``"stages"`` (``trace.segment``): each segment is
four hand-written kernels with the scan and the records between them,
bit-equal to the eager route. Every other batch takes ``"eager"``: the
segment as torch ops, where the intersection queries, the Philox draws,
the table reads and the histogram record (and its backward) are
hand-written CUDA kernels on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace

import numpy as np
import torch

from .. import units as u
from ..accel import SurfaceHit, intersect_scene, intersect_target, offset_ray
from ..callback import EmptyEventCallback, TraceEventCallback
from ..component import Component, TraceConfig, host_dict, resolve_device
from ..light import LightSource, WavelengthSource
from ..material import MaterialFlags, MediumConstants, lookup_packed, packed_medium_constants
from ..ops.math3d import dot, local_frame, normalize, sqrt
from ..ops.sampling import scatter_dir
from ..ops.table_read import PHASE, read_packed
from ..polarization import (
    apply_phase_matrix,
    apply_polarizer,
    apply_rotation,
    polarizer_coeffs,
    rotate_pol_ref,
    unpolarized_stokes,
)
from ..random import RNG
from ..scene import Scene, ScenePack
from ..target import TargetGuide
from .core import (
    EventResultCode,
    HitItem,
    PropagateParams,
    RayState,
    TracerBase,
    active_lanes,
    create_hit,
    merge_dim,
    propagate_ray,
    reattach_geometry,
    sample_scatter_length,
    select_ray,
    update_ray,
    update_ray_is,
)

__all__ = ["SceneForwardTracer"]

_BLACK = int(MaterialFlags.BLACK_BODY)
_DETECTOR = int(MaterialFlags.DETECTOR)
_NO_R_FWD = int(MaterialFlags.NO_REFLECT_FWD)
_NO_T_FWD = int(MaterialFlags.NO_TRANSMIT_FWD)
_VOLUME = int(MaterialFlags.VOLUME_BORDER)
_LOG_INV_4PI = float(np.log(np.float32(1.0 / (4.0 * np.pi))))


def _phase_matrix_packed(store, handle, cos_theta):
    """(m12, m22, m33, m34) from the packed per-medium tables
    (reference: polarization.glsl:88-107)."""
    kinds = ("phase_m12", "phase_m22", "phase_m33", "phase_m34")
    return read_packed(
        tuple(store.tables[k] for k in kinds), tuple(store.sizes[k] for k in kinds), handle, cos_theta, 0.0,
        affine=PHASE,
    )


def _log_phase_packed(store, handle, cos_theta):
    """The log phase function at the cosine from the packed tables,
    log(1/4pi) where a medium has none."""
    return read_packed(
        store.tables["log_phase_function"], store.sizes["log_phase_function"], handle, cos_theta, _LOG_INV_4PI,
        affine=PHASE,
    )


def _pol_scatter_packed(store, handle, direction, new_dir, pol):
    """Rotate to the scattering plane and apply the phase matrix
    (reference: ray.scatter.glsl:46-69)."""
    stokes, pol_ref = pol
    m12, m22, m33, m34 = _phase_matrix_packed(store, handle, dot(direction, new_dir))
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, new_dir)
    stokes = apply_phase_matrix(apply_rotation(stokes, c, s), m12, m22, m33, m34)
    return stokes, new_ref


def _pol_align(direction, pol, hit_normal):
    """Rotate the frame perpendicular to the plane of incidence
    (reference: ray.propagate.glsl:187-201 alignRayToHit)."""
    stokes, pol_ref = pol
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, hit_normal)
    return apply_rotation(stokes, c, s), new_ref


def _where_pol(mask, a, b):
    """Per-lane select of two (stokes, pol_ref) pairs."""
    return tuple(torch.where(mask[..., None], x, y) for x, y in zip(a, b))


def _split_hit(hit: SurfaceHit, n: int) -> tuple[SurfaceHit, SurfaceHit]:
    """The two halves of a 2N-lane hit."""
    fields = [f.name for f in dataclasses.fields(hit)]
    return tuple(SurfaceHit(**{f: getattr(hit, f)[sl] for f in fields}) for sl in (slice(None, n), slice(n, None)))


def _cat_constants(c: MediumConstants) -> MediumConstants:
    tile = lambda a: torch.cat([a, a])
    return MediumConstants(n=tile(c.n), vg=tile(c.vg), mu_s=tile(c.mu_s), mu_e=tile(c.mu_e))


def _reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def _refract(i, n, eta):
    """GLSL refract(); returns the (unit) inverted normal on total internal
    reflection so callers may normalize — TIR lanes are masked out by the
    selection logic."""
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k <= 0.0
    k_safe = torch.where(tir, 1.0, k)
    out = eta[..., None] * i - (eta * cos_i + sqrt(k_safe))[..., None] * n
    return torch.where(tir[..., None], -n, out)


def _fresnel(pack: ScenePack, ray: RayState, hit: SurfaceHit):
    """(n_in, n_tr, r_s, r_p) per lane
    (reference: shader/scatter.surface.glsl:21-51)."""
    cos_i = torch.clamp(dot(ray.direction, hit.ray_nrm), -1.0, 1.0)
    sin_i = sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    n_i = ray.constants.n
    # the wavelength normalized by the medium's bounds and clipped, then
    # read (which clips again), in one read
    n_t = read_packed(
        pack.media.tables["refractive_index"],
        pack.media.sizes["refractive_index"],
        hit.medium_tr,
        ray.wavelength,
        1.0,
        bounds=(pack.media.lambda_min, pack.media.lambda_max),
        clips=2,
    )
    sin_t = sin_i * n_i / n_t
    # double where: the square root's slope at a clamped 0 is infinite and
    # would make the index's gradient NaN on total-internal-reflection lanes
    s2 = 1.0 - sin_t * sin_t
    tir = s2 <= 0.0
    cos_t = torch.where(tir, 0.0, sqrt(torch.where(tir, 1.0, s2)))
    cos_i = torch.abs(cos_i)
    r_s = (n_i * cos_i - n_t * cos_t) / (n_i * cos_i + n_t * cos_t)
    r_p = (n_t * cos_i - n_i * cos_t) / (n_t * cos_i + n_i * cos_t)
    return n_i, n_t, r_s, r_p


def scene_propagation(pack: ScenePack, tracer_params) -> PropagateParams:
    """A scene tracer's propagation bounds: the scene's box, its diagonal
    as the longest step, the tracer's scatter coefficient and time limit."""
    extent = pack.upper_bbox - pack.lower_bbox
    return PropagateParams(
        scatter_coefficient=tracer_params["scatterCoefficient"],
        lower_bbox=pack.lower_bbox,
        upper_bbox=pack.upper_bbox,
        max_time=tracer_params["maxTime"],
        max_dist=sqrt(dot(extent, extent)),
    )


def _sample_cos_packed(pack: ScenePack, medium, u):
    """The phase function's sampled cosine from the packed sampling
    tables, detached (a sampler's state); uniform where the medium has no
    table. Returns (cos_theta, has_table)."""
    sizes = pack.media.sizes["phase_sampling"]
    cos_tab = lookup_packed(pack.media.tables["phase_sampling"], sizes, medium, u, 0.0)
    has_tab = sizes[medium] > 0
    return torch.where(has_tab, torch.clamp(cos_tab, -1.0, 1.0), 2.0 * u - 1.0).detach(), has_tab


def _mis_contrib(ray: RayState, w, log_p):
    """A MIS shadow ray's (lin, log) contribution: the vertex's times mu_s
    and its balance weight, with the sampled log probability's
    zero-valued correction."""
    return ray.lin_contrib * ray.constants.mu_s * w.detach(), ray.log_contrib + log_p - log_p.detach()


def _result_codes(code, pre_alive, in_bounds, surf, respond, vol_border, absorbed_surf):
    """A segment's result codes (int32) and the lanes that stay alive."""
    E = EventResultCode
    code = torch.where(
        surf & respond, int(E.RAY_DETECTED),
        torch.where(
            surf & vol_border, int(E.VOLUME_HIT),
            torch.where(
                surf, int(E.RAY_HIT),
                torch.where(pre_alive & in_bounds, int(E.RAY_SCATTERED), code),
            ),
        ),
    )
    code = torch.where(absorbed_surf, int(E.RAY_ABSORBED), code).to(torch.int32)
    return code, pre_alive & (code >= 0) & ~absorbed_surf


class SceneForwardTracer(TracerBase):
    """Forward path tracing against a scene (reference:
    src/theia/trace.py:1048-1336). Lanes and parameters live on
    ``device``: the card unless the caller names another; without a card
    the default raises, and ``device="cpu"`` runs on the CPU."""

    name = "Scene Forward Tracer"
    _param_names = ("targetId", "scatterCoefficient", "maxTime")
    # direction hooks (theia_tpu's SceneBackwardTargetTracer flips these)
    _target_bit = _DETECTOR
    _no_r_bit = _NO_R_FWD
    _no_t_bit = _NO_T_FWD
    _transmit_eta2 = False  # backward radiance transport takes eta^2
    #: photon mode (ScenePhotonTracer): contributions start at 1 and each
    #: segment ends in Russian-roulette absorption
    _photon_mode = False
    #: conformance hook: a list to which either route appends each
    #: segment's end state (``trace.segment.snapshot``), or None
    _debug_segments = None

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        wavelengthSource: WavelengthSource,
        response,
        rng: RNG,
        scene: Scene,
        *,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        maxPathLength: int = 6,
        targetId: int = -1,
        targetGuide: TargetGuide | None = None,
        scatterCoefficient: float = float("nan"),
        sourceMedium: str | None = None,
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
        disableTransmission: bool = False,
        disableVolumeBorder: bool = False,
        useRefractedHitDir: bool = False,
        refCompatRNG: bool = False,
        device="cuda",
    ) -> None:
        if not source.supportForward:
            raise ValueError("light source does not support forward mode")
        self.device = resolve_device(device)
        self._init_batch(batchSize, capacity)
        self.source = source
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.scene = scene
        self.callback = EmptyEventCallback() if callback is None else callback
        self.maxPathLength = maxPathLength
        self.targetId = targetId
        self.targetGuide = targetGuide
        self.scatterCoefficient = scatterCoefficient
        self.sourceMedium = sourceMedium if sourceMedium is not None else scene.medium
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting
        self.disableTransmission = disableTransmission
        self.disableVolumeBorder = disableVolumeBorder
        self.useRefractedHitDir = useRefractedHitDir

        # draw budget per path, as theia_tpu.trace.scene: a guided miss
        # segment draws dist(1) + phase(2) + guide(N) + scatter(2) = 5 + N,
        # where the reference's stride (4 + N, refCompatRNG=True) overlaps
        # Philox streams between batches
        self.refCompatRNG = refCompatRNG
        maxHits = maxPathLength - 1
        rngStride = 4
        if targetGuide is not None:
            maxHits *= 2
            rngStride = (4 if refCompatRNG else 5) + targetGuide.nRNGSamples
        if not disableDirectLighting:
            maxHits += 1
        self.maxHitsPerThread = maxHits
        self.nRNGSamples = (
            source.nRNGForward
            + wavelengthSource.nRNGSamples
            + rngStride * maxPathLength
            + maxHits * response.nRNGSamples
        )
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

    @property
    def segment_route(self) -> str:
        """``"stages"`` where a batch of this tracer runs now would take the
        four segment kernels (``trace.segment.route`` says when), else
        ``"eager"``."""
        from . import segment

        return segment.route(self)

    @property
    def _fused(self) -> bool:
        """Whether the responses fuse (``theia_tpu``'s default rule): a
        guide, a response that draws nothing, no polarization."""
        return self.targetGuide is not None and self.response.nRNGSamples == 0 and not self.polarized

    # -- params ----------------------------------------------------------

    def collectStages(self) -> list[tuple[str, Component]]:
        stages = [("photons", self.wavelengthSource), ("lightSource", self.source)]
        if self.targetGuide is not None:
            stages.append(("guide", self.targetGuide))
        stages += [("tracer", self), ("callback", self.callback), ("response", self.response)]
        return stages

    def params(self):
        dev = self.device
        p = {
            "tracer": host_dict({
                "batchSize": (self.batchSize, np.int64),
                "targetId": (self.targetId, np.int32),
                "scatterCoefficient": (self.scatterCoefficient, np.float32),
                "maxTime": (self.maxTime, np.float32),
            }, dev),
            "scene": self.scene.pack,
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
        }
        if self.targetGuide is not None:
            p["guide"] = self.targetGuide.params(dev)
        return p

    def _propagation(self, p) -> PropagateParams:
        return scene_propagation(p["scene"], p["tracer"])

    # -- physics helpers -------------------------------------------------

    def _scatter_prob_packed(self, pack: ScenePack, medium, in_dir, out_dir):
        """Phase function value via the packed log-phase tables."""
        log_p = _log_phase_packed(pack.media, medium, dot(in_dir, out_dir))
        return torch.exp(log_p), log_p

    def _sample_phase_packed(self, pack: ScenePack, medium, in_dir, u1, u2):
        """Importance sample the phase function from packed tables.
        Returns (direction, pdf, log_p) — uniform-sphere fallback where the
        medium has no sampling table."""
        phi = 2.0 * np.pi * u1
        cos_theta, has_tab = _sample_cos_packed(pack, medium, u2)
        direction = scatter_dir(in_dir, cos_theta, phi)
        p, log_p = self._scatter_prob_packed(pack, medium, in_dir, direction)
        pdf = torch.where(has_tab, p, float(np.float32(1.0 / (4.0 * np.pi))))
        return direction, pdf, log_p

    def _create_response_item(
        self, ray: RayState, hit: SurfaceHit, r_s, r_p, n_i, n_t, absorb, pol=None
    ) -> tuple[HitItem, torch.Tensor]:
        """Build the detector HitItem, emulating transmission where the
        surface is not absorbing (reference: scene.traverse.glsl:31-69).
        Returns (item, contrib>0 mask)."""
        transmittance = 1.0 - 0.5 * (r_s * r_s + r_p * r_p)
        lin = torch.where(absorb, ray.lin_contrib, ray.lin_contrib * transmittance)
        if pol is not None:
            # align perpendicular to the plane of incidence, then apply the
            # transmission polarizer for non-absorbing detectors
            # (reference: ray.surface.glsl transmitRay polarized)
            stokes, pol_ref = _pol_align(ray.direction, pol, hit.ray_nrm)
            t_s = r_s + 1.0
            t_p = (r_p + 1.0) * (n_i / n_t)
            _, m12, m33 = polarizer_coeffs(t_p, t_s)
            stokes = torch.where(absorb[..., None], stokes, apply_polarizer(stokes, m12, m33))
            pol = (stokes, pol_ref)
        ray = replace(ray, lin_contrib=lin)
        if self.useRefractedHitDir:
            # the direction is sampler state: detached from the IOR gradient
            refr = normalize(_refract(ray.direction, hit.ray_nrm, (n_i / n_t).detach()))
            ray = replace(ray, direction=torch.where(absorb[..., None], ray.direction, refr))
        item = create_hit(
            ray, hit.obj_pos, hit.obj_nrm, hit.custom_id, hit.world_to_obj, pol=pol
        )
        return item, item.contrib > 0.0

    def _propagate_to_hit(self, ray: RayState, hit: SurfaceHit, prop):
        delta = hit.world_pos - ray.position
        dist = sqrt(torch.clamp_min(dot(delta, delta), 1e-30))
        new, code = update_ray(replace(ray, position=hit.world_pos), dist, prop)
        # deterministic connection distance: reattach its gradient
        return reattach_geometry(new, dist), code

    def _shadow_item(self, p, ray: RayState, hit: SurfaceHit, mask, prop, pol=None):
        """processShadowRay's item half: the detector HitItem + validity
        for a (batched) shadow wavefront
        (reference: scene.traverse.glsl:160-183)."""
        pack: ScenePack = p["scene"]
        target_id = p["tracer"]["targetId"]
        is_target = (hit.flags & self._target_bit) != 0
        correct = (target_id < 0) | (hit.custom_id == target_id)
        ok = mask & hit.valid & is_target & correct & (hit.error == 0)
        moved, code = self._propagate_to_hit(ray, hit, prop)
        ok = ok & (code >= 0)
        n_i, n_t, r_s, r_p = _fresnel(pack, moved, hit)
        absorb = (hit.flags & _BLACK) != 0
        item, pos_mask = self._create_response_item(
            moved, hit, r_s, r_p, n_i, n_t, absorb, pol=pol
        )
        return item, ok & pos_mask

    def _shadow_response(self, p, resp_state, ray: RayState, hit: SurfaceHit, mask, rng, prop, pol=None):
        """processShadowRay: the response if the shadow ray reached the
        target, with the response's draws kept on recorded lanes only
        (reference: scene.traverse.glsl:160-183)."""
        item, ok = self._shadow_item(p, ray, hit, mask, prop, pol=pol)
        resp_state, rng_after = self.response.record(p["response"], resp_state, item, ok, rng)
        return resp_state, merge_dim(rng_after, rng, ok)

    def _sample_initial(self, p, pack, streams, rng):
        """Sample the initial rays (forward: wavelength + light source)."""
        (lam, lam_contrib), rng = self.wavelengthSource.sample(p["photons"], rng)
        src_medium = torch.full(
            streams.shape, pack.media.handle(self.sourceMedium),
            dtype=torch.int32, device=streams.device,
        )
        constants = packed_medium_constants(pack.media, src_medium, lam)
        src, rng = self.source.sample_forward(p["lightSource"], lam, constants, rng)
        ray = RayState(
            position=src.position,
            direction=src.direction,
            wavelength=lam,
            time=src.start_time,
            lin_contrib=torch.ones_like(lam) if self._photon_mode else src.contrib * lam_contrib,
            log_contrib=torch.zeros_like(lam),
            constants=constants,
        )
        pol = None
        if self.polarized:
            # unpolarized sources get a frame from the local basis
            # (reference: lightsource.common.glsl createSourceRay)
            stokes = (
                src.stokes if src.stokes is not None
                else unpolarized_stokes(lam.shape, device=lam.device)
            )
            pol_ref = src.pol_ref if src.pol_ref is not None else local_frame(src.direction)[0]
            pol = (stokes, pol_ref)
        return ray, src_medium, pol, rng

    # -- one segment -----------------------------------------------------

    def _segment(self, p, pack, prop, carry, i: int, last: bool):
        """One path segment. ``last`` peels the final segment: there every
        lane has ``miss == False``, so the MIS shadow block and the scatter
        block would only add zeros and restore their RNG dims; they are
        skipped (reference: the loop's last iteration never scatters,
        tracer.scene.forward.glsl loop bound)."""
        ray, medium, alive, allow_response, pol, rng, resp_state, cb_state = carry
        mis = self.targetGuide is not None
        fused = self._fused

        # health check (reference: scene.traverse.glsl:288-290)
        alive = alive & ~ray.is_bad()
        pre_alive = alive

        # ---- trace() (scene.traverse.glsl:286-352) ----
        uu, rng = rng.uniform()
        dist = sample_scatter_length(ray, prop, uu)
        sampled_dist = dist
        if mis:
            guide_eval = self.targetGuide.eval(p["guide"], ray.position, ray.direction)
            mis_ext = allow_response & (guide_eval.prob > 0.0) & (guide_eval.dist > dist)
            dist = torch.where(mis_ext, torch.maximum(guide_eval.dist, dist), dist)

        hit = intersect_scene(pack, medium, ray.position, ray.direction, dist)
        travel = torch.where(hit.valid, hit.t, dist)

        ext_ok = None
        if mis:
            # a hit beyond the sampled distance is a free shadow ray. Fused,
            # its response rides on the main record (the masks are per-lane
            # exclusive and share the hit rows); else it is its own record
            ext_mask = (
                pre_alive & mis_ext & hit.valid
                & (travel > sampled_dist) & (hit.error == 0)
            )
            if fused:
                ext_ray, ext_code = self._propagate_to_hit(ray, hit, prop)
                ext_ok = ext_mask & (ext_code >= 0)
            else:
                resp_state, rng = self._shadow_response(
                    p, resp_state, ray, hit, ext_mask, rng, prop, pol=pol
                )
            hit = replace(hit, valid=hit.valid & ~ext_mask)
            travel = torch.where(ext_mask, sampled_dist, travel)

        ray, code = propagate_ray(ray, travel, prop)
        ray = reattach_geometry(ray, travel, valid=hit.valid)
        ray = update_ray_is(ray, travel, prop, hit.valid)
        # media mismatch error dominates
        code = torch.where(hit.valid & (hit.error != 0), hit.error, code)
        in_bounds = code >= 0

        # ---- processInteraction: surface hit ----
        surf = pre_alive & in_bounds & hit.valid
        ray = replace(
            ray, position=torch.where(surf[..., None], hit.world_pos, ray.position)
        )
        n_i, n_t, r_s, r_p = _fresnel(pack, ray, hit)
        kinds = self._surface_kinds(hit.flags, surf)
        is_abs, is_target, vol_border = kinds[:3]

        target_id = p["tracer"]["targetId"]
        correct = (target_id < 0) | (hit.custom_id == target_id)
        respond = surf & allow_response & is_target & correct
        # align the polarization frame perpendicular to the plane of
        # incidence on surface lanes (alignRayToHit); uses the incident
        # direction, so it comes before the new direction is chosen
        if pol is not None:
            pol = _where_pol(surf, _pol_align(ray.direction, pol, hit.ray_nrm), pol)
        resp_ray, rec_mask = ray, respond
        if ext_ok is not None:
            # extension lanes respond with their propagated-to-hit state;
            # the masks are disjoint (ext lanes left ``surf`` above)
            resp_ray = select_ray(ext_ok, ext_ray, ray)
            rec_mask = rec_mask | (ext_ok & is_target & correct)
        item, pos_ok = self._create_response_item(
            resp_ray, hit, r_s, r_p, n_i, n_t, is_abs, pol=pol
        )
        rec_mask = rec_mask & pos_ok
        resp_state, rng_a = self.response.record(p["response"], resp_state, item, rec_mask, rng)
        rng = merge_dim(rng_a, rng, rec_mask)

        # surface interaction outcome
        ray, medium, rng, sel_reflect, sel_transmit, eta, absorbed_surf = self._surface_outcome(
            pack, ray, medium, hit, surf, kinds, r_s, r_p, n_i, n_t, rng
        )
        if pol is not None:
            # Fresnel polarizers in the (already aligned) incidence frame;
            # the reference frame itself is kept by both outcomes
            # (reference: ray.surface.glsl reflectRay/transmitRay)
            stokes, pol_ref = pol
            _, m12_r, m33_r = polarizer_coeffs(r_p, r_s)
            _, m12_t, m33_t = polarizer_coeffs((r_p + 1.0) * eta, r_s + 1.0)
            stokes = torch.where(
                sel_reflect[..., None], apply_polarizer(stokes, m12_r, m33_r),
                torch.where(
                    sel_transmit[..., None], apply_polarizer(stokes, m12_t, m33_t), stokes
                ),
            )
            pol = (stokes, pol_ref)

        # ---- processInteraction: volume scatter (miss) ----
        if not last:
            miss = pre_alive & in_bounds & ~hit.valid
            if mis:
                resp_state, rng = self._mis_shadow(
                    p, pack, prop, ray, medium, miss, pol, rng, resp_state
                )
            # scatter the real ray
            incident = ray
            ray, scat_dir, rng = self._scatter_real(pack, ray, medium, miss, rng)
            if pol is not None:
                pol = _where_pol(
                    miss, _pol_scatter_packed(pack.media, medium, incident.direction, scat_dir, pol), pol
                )

        # ---- result codes + events ----
        E = EventResultCode
        code, alive = _result_codes(code, pre_alive, in_bounds, surf, respond, vol_border, absorbed_surf)
        if self._photon_mode:
            # Russian-roulette absorption every segment (no MIS in photon
            # mode, so a segment's draws are fixed)
            u_abs, rng_a = rng.uniform()
            survive = ray.contrib > u_abs
            rng = merge_dim(rng_a, rng, alive)
            kept = alive & survive
            ray = replace(
                ray,
                lin_contrib=torch.where(kept, 1.0, ray.lin_contrib),
                log_contrib=torch.where(kept, 0.0, ray.log_contrib),
            )
            code = torch.where(alive & ~survive, int(E.RAY_ABSORBED), code).to(torch.int32)
            alive = kept
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, code, pre_alive, i + 1, pol=pol
        )
        if mis:
            allow_response = code != int(E.RAY_SCATTERED)
        else:
            allow_response = torch.ones_like(allow_response)
        return ray, medium, alive, allow_response, pol, rng, resp_state, cb_state

    def _mis_shadow(self, p, pack, prop, ray, medium, miss, pol, rng, resp_state):
        """The two MIS shadow rays of a scatter vertex (phase sample and
        guide sample), traced as one 2N-lane query. Fused, they are
        recorded in one call; else each half is its own record, phase
        sample first, each with its own Stokes vector scattered into its
        direction. The RNG dims advance only on ``miss`` lanes."""
        rng_b = rng
        dir_phase, guide_sample, phase_eval, w_phase, w_target, log_p_pp, log_p_pt, rng = self._mis_samples(
            p, pack, ray, medium, rng
        )

        tile = lambda a: torch.cat([a, a])
        directions = torch.cat([dir_phase, guide_sample.direction])
        hit2 = intersect_target(
            pack, tile(medium), tile(ray.position), directions,
            torch.cat([phase_eval.dist, guide_sample.dist]),
            active=tile(miss),
        )
        if not self._fused:
            halves = zip(
                _split_hit(hit2, miss.shape[0]),
                ((dir_phase, w_phase, log_p_pp), (guide_sample.direction, w_target, log_p_pt)),
            )
            for s_hit, (s_dir, w, log_p) in halves:
                lin, log = _mis_contrib(ray, w, log_p)
                shadow = replace(ray, direction=s_dir, lin_contrib=lin, log_contrib=log)
                shadow_pol = None
                if pol is not None:
                    shadow_pol = _pol_scatter_packed(pack.media, medium, ray.direction, s_dir, pol)
                resp_state, rng = self._shadow_response(
                    p, resp_state, shadow, s_hit, miss, rng, prop, pol=shadow_pol
                )
            return resp_state, merge_dim(rng, rng_b, miss)
        lin_p, log_p = _mis_contrib(ray, w_phase, log_p_pp)
        lin_t, log_t = _mis_contrib(ray, w_target, log_p_pt)
        shadow2 = RayState(
            position=tile(ray.position),
            direction=directions,
            wavelength=tile(ray.wavelength),
            time=tile(ray.time),
            lin_contrib=torch.cat([lin_p, lin_t]),
            log_contrib=torch.cat([log_p, log_t]),
            constants=_cat_constants(ray.constants),
        )
        item2, ok2 = self._shadow_item(p, shadow2, hit2, tile(miss), prop)
        resp_state, _ = self.response.record(p["response"], resp_state, item2, ok2, rng)
        return resp_state, merge_dim(rng, rng_b, miss)

    # -- the pieces that the staged route's twins share (trace.segment) ---

    def _surface_kinds(self, flags, surf):
        """(is_abs, is_target, vol_border, can_reflect, can_transmit) of the
        hit materials' ``flags``, under the tracer's surface rules."""
        no = torch.zeros_like(surf)
        is_abs = (flags & _BLACK) != 0
        is_target = (flags & self._target_bit) != 0
        vol_border = no if self.disableVolumeBorder else (flags & _VOLUME) != 0
        can_reflect = (flags & self._no_r_bit) == 0
        can_transmit = no if self.disableTransmission else (flags & self._no_t_bit) == 0
        return is_abs, is_target, vol_border, can_reflect, can_transmit

    def _surface_outcome(self, pack, ray, medium, hit, surf, kinds, r_s, r_p, n_i, n_t, rng):
        """The surface interaction on ``surf`` lanes: the draw between
        reflection and transmission, all three outcomes computed and
        selected per lane, the new medium and its constants. ``kinds`` is
        :meth:`_surface_kinds`' tuple. Returns (ray, medium, rng,
        sel_reflect, sel_transmit, eta, absorbed_surf)."""
        sg = lambda a: a.detach()
        is_abs, _, vol_border, can_reflect, can_transmit = kinds
        r_coef = 0.5 * (r_s * r_s + r_p * r_p)
        u_surf, rng_a = rng.uniform()
        both = surf & ~is_abs & ~vol_border & can_reflect & can_transmit
        rng = merge_dim(rng_a, rng, both)
        do_reflect = torch.where(both, u_surf < sg(r_coef), can_reflect)
        absorbed_surf = surf & (is_abs | (~can_reflect & ~can_transmit & ~vol_border))

        # compute all three outcomes and select per lane
        refl_dir = normalize(_reflect(ray.direction, hit.ray_nrm))
        refl_pos = offset_ray(hit.world_pos, hit.ray_nrm)
        refl_factor = torch.where(both, 1.0, r_coef)
        refl_log = torch.where(both, torch.log(torch.clamp_min(r_coef, 1e-30)), 0.0)
        refl_corr = refl_log - sg(refl_log)
        eta = n_i / n_t
        trans_dir = normalize(_refract(ray.direction, hit.ray_nrm, sg(eta)))
        trans_pos = offset_ray(hit.world_pos, -hit.ray_nrm)
        trans_factor = torch.where(both, 1.0, 1.0 - r_coef)
        if self._transmit_eta2:
            # backward rays transport radiance: eta^2 on transmission
            # (reference: ray.surface.glsl transmitRayIS backward)
            trans_factor = trans_factor * (eta * eta)
        trans_log = torch.where(
            both, torch.log(torch.clamp_min(1.0 - r_coef, 1e-30)), 0.0
        )
        trans_corr = trans_log - sg(trans_log)
        border_pos = trans_pos  # straight through, medium change

        new_medium = torch.where(
            surf & (vol_border | (~do_reflect & can_transmit & ~is_abs)),
            hit.medium_tr,
            medium,
        )
        crossed = new_medium != medium
        sel_reflect = surf & ~is_abs & ~vol_border & do_reflect & can_reflect
        sel_transmit = surf & ~is_abs & ~vol_border & ~do_reflect & can_transmit

        new_dir = torch.where(
            sel_reflect[..., None], refl_dir,
            torch.where(sel_transmit[..., None], trans_dir, ray.direction),
        )
        new_pos = torch.where(
            sel_reflect[..., None], refl_pos,
            torch.where(
                (sel_transmit | (surf & vol_border))[..., None],
                torch.where(sel_transmit[..., None], trans_pos, border_pos),
                ray.position,
            ),
        )
        new_lin = torch.where(
            sel_reflect, ray.lin_contrib * refl_factor,
            torch.where(sel_transmit, ray.lin_contrib * trans_factor, ray.lin_contrib),
        )
        new_log = torch.where(
            sel_reflect, ray.log_contrib + refl_corr,
            torch.where(sel_transmit, ray.log_contrib + trans_corr, ray.log_contrib),
        )
        new_c = packed_medium_constants(pack.media, new_medium, ray.wavelength)
        old_c = ray.constants
        ray = RayState(
            position=new_pos,
            direction=new_dir,
            wavelength=ray.wavelength,
            time=ray.time,
            lin_contrib=new_lin,
            log_contrib=new_log,
            constants=MediumConstants(
                *(torch.where(crossed, getattr(new_c, f), getattr(old_c, f))
                  for f in ("n", "vg", "mu_s", "mu_e"))
            ),
        )
        return ray, new_medium, rng, sel_reflect, sel_transmit, eta, absorbed_surf

    def _mis_samples(self, p, pack, ray, medium, rng):
        """A scatter vertex's two MIS directions, the phase sample and the
        guide sample, with the guide's view of the first and the balance
        weights of both. Returns (dir_phase, guide_sample, phase_eval,
        w_phase, w_target, log_p_pp, log_p_pt, rng)."""
        sg = lambda a: a.detach()
        (u1, u2), rng = rng.uniform2d()
        dir_phase, p_pp, log_p_pp = self._sample_phase_packed(
            pack, medium, ray.direction, u1, u2
        )
        guide_sample, rng = self.targetGuide.sample(p["guide"], ray.position, rng)
        phase_eval = self.targetGuide.eval(p["guide"], ray.position, dir_phase)
        p_tt = sg(guide_sample.prob)
        p_tp = sg(phase_eval.prob)
        p_pt, log_p_pt = self._scatter_prob_packed(
            pack, medium, ray.direction, guide_sample.direction
        )
        p_pt_d, p_pp_d = sg(p_pt), sg(p_pp)
        w_target = p_tt * p_pt_d / (p_tt**2 + p_pt_d**2)
        w_phase = p_pp_d**2 / (p_pp_d**2 + p_tp**2)
        w_target = torch.nan_to_num(w_target, nan=0.0, posinf=0.0, neginf=0.0)
        w_phase = torch.nan_to_num(w_phase, nan=0.0, posinf=0.0, neginf=0.0)
        return dir_phase, guide_sample, phase_eval, w_phase, w_target, log_p_pp, log_p_pt, rng

    def _scatter_real(self, pack, ray, medium, miss, rng):
        """The real ray's phase scatter on ``miss`` lanes, whose RNG dims
        alone advance. Returns (ray, the sampled direction, rng)."""
        rng_b = rng
        (su1, su2), rng = rng.uniform2d()
        scat_dir, _, scat_log_p = self._sample_phase_packed(
            pack, medium, ray.direction, su1, su2
        )
        scat_corr = scat_log_p - scat_log_p.detach()
        ray = replace(
            ray,
            direction=torch.where(miss[..., None], scat_dir, ray.direction),
            lin_contrib=torch.where(
                miss, ray.lin_contrib * ray.constants.mu_s, ray.lin_contrib
            ),
            log_contrib=torch.where(miss, ray.log_contrib + scat_corr, ray.log_contrib),
        )
        return ray, scat_dir, merge_dim(rng, rng_b, miss)

    # -- the batch -------------------------------------------------------

    def _initial_carry(self, p, pack, streams, rng):
        """(ray, medium, alive, allow_response, pol, rng) of a fresh batch."""
        ray, medium, pol, rng = self._sample_initial(p, pack, streams, rng)
        alive = active_lanes(streams, p) & ~ray.is_bad()
        allow_response = torch.full_like(alive, not self.disableDirectLighting)
        return ray, medium, alive, allow_response, pol, rng

    def _trace_batch(self, p, counter, streams):
        if self.segment_route == "stages":
            from . import segment

            return segment.trace_stages(self, p, counter, streams)
        return self._trace_batch_eager(p, counter, streams)

    def _trace_batch_eager(self, p, counter, streams):
        """A batch on the eager route, whatever ``segment_route`` says: the
        autograd path, and what checks hold the staged route against."""
        pack: ScenePack = p["scene"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)
        ray, medium, alive, allow_response, pol, rng = self._initial_carry(p, pack, streams, rng)

        resp_state = self.response.init(streams.device)
        cb_state = self.callback.init(streams.shape[0], self.maxPathLength + 2, streams.device)
        created = torch.full_like(streams, int(EventResultCode.RAY_CREATED))
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, created, active_lanes(streams, p), 0, pol=pol
        )
        carry = (ray, medium, alive, allow_response, pol, rng, resp_state, cb_state)
        for i in range(self.maxPathLength):
            carry = self._segment(p, pack, prop, carry, i, i == self.maxPathLength - 1)
            if self._debug_segments is not None:
                from .segment import snapshot

                self._debug_segments.append(snapshot(carry[0], carry[1], carry[2], carry[3], carry[5].dim))
        ray, medium, alive, allow_response, pol, rng, resp_state, cb_state = carry
        max_iter = torch.full_like(streams, int(EventResultCode.MAX_ITER))
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, max_iter, alive, self.maxPathLength + 1, pol=pol
        )
        if self._debug_rng:
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state
