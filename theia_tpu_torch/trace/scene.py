"""Scene forward tracer: full geometry with Fresnel media boundaries.

The port of ``theia_tpu.trace.scene.SceneForwardTracer``, unpolarized or
polarized (a Stokes vector and its reference frame ride with each ray).
Per segment: exponential distance sampling, the target-guide free-shadow-
ray extension, scene intersection with media-mismatch checks, surface
interaction (Fresnel reflect/transmit/volume-border/black-body by
material flags) or volume scatter with guide MIS (reference:
src/theia/trace.py:1048-1336, shader/tracer.scene.forward.glsl,
shader/scene.traverse.glsl).

The responses are fused as in the JAX package's default: the free-
extension shadow response rides on the main surface record, and the two
MIS shadow rays go through one 2N-lane intersection and one record. The
JAX package fuses only unpolarized runs; the port fuses polarized runs
too, carrying each lane's Stokes vector through the fused records, which
adds the same hits in another order (float32 rounding apart, the same
histogram). The final segment is peeled: it never scatters, so it skips
the MIS shadow and scatter blocks. The whole batch runs eagerly; the
nearest-hit query, the Philox draws and the histogram record (and its
backward) are hand-written CUDA kernels on a CUDA device.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import units as u
from ..accel import SurfaceHit, intersect_scene, intersect_target, offset_ray
from ..callback import EmptyEventCallback, TraceEventCallback
from ..component import TraceConfig, resolve_device
from ..light import LightSource, WavelengthSource
from ..material import MaterialFlags, MediumConstants, lookup_packed, packed_medium_constants
from ..ops.math3d import dot, local_frame, normalize
from ..ops.sampling import scatter_dir
from ..polarization import (
    apply_phase_matrix,
    apply_polarizer,
    apply_rotation,
    polarizer_coeffs,
    rotate_pol_ref,
    unpolarized_stokes,
)
from ..random import PhiloxRNG, RNGState
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
    propagate_ray,
    reattach_geometry,
    sample_scatter_length,
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
    t = 0.5 * (cos_theta + 1.0)
    return tuple(
        lookup_packed(store.tables[k], store.sizes[k], handle, t, 0.0)
        for k in ("phase_m12", "phase_m22", "phase_m33", "phase_m34")
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


def _merge_dim(after: RNGState, before: RNGState, take_after) -> RNGState:
    return replace(before, dim=torch.where(take_after, after.dim, before.dim))


def _where_ray(mask: torch.Tensor, a: RayState, b: RayState) -> RayState:
    """Per-lane select of two ray states' position/time/contributions."""
    return replace(
        b,
        position=torch.where(mask[..., None], a.position, b.position),
        time=torch.where(mask, a.time, b.time),
        lin_contrib=torch.where(mask, a.lin_contrib, b.lin_contrib),
        log_contrib=torch.where(mask, a.log_contrib, b.log_contrib),
    )


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
    out = eta[..., None] * i - (eta * cos_i + torch.sqrt(k_safe))[..., None] * n
    return torch.where(tir[..., None], -n, out)


class SceneForwardTracer(TracerBase):
    """Forward path tracing against a scene (reference:
    src/theia/trace.py:1048-1336). Lanes and parameters live on
    ``device``: the card unless the caller names another; without a card
    the default raises, and ``device="cpu"`` runs on the CPU."""

    name = "Scene Forward Tracer"
    _param_names = ("targetId", "scatterCoefficient", "maxTime")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        wavelengthSource: WavelengthSource,
        response,
        rng: PhiloxRNG,
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
        device="cuda",
    ) -> None:
        if targetGuide is None:
            raise NotImplementedError(
                "scene tracing without a target guide is not ported yet"
            )
        if not source.supportForward:
            raise ValueError("light source does not support forward mode")
        if response.nRNGSamples != 0:
            raise NotImplementedError(
                "responses that draw random numbers are not ported yet"
            )
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

        # draw budget per path, as theia_tpu.trace.scene: a guided miss
        # segment draws dist(1) + phase(2) + guide(N) + scatter(2) = 5 + N
        maxHits = 2 * (maxPathLength - 1) + 1
        rngStride = 5 + targetGuide.nRNGSamples
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

    # -- params ----------------------------------------------------------

    def params(self):
        dev = self.device
        p = {
            "tracer": {
                "batchSize": torch.tensor(self.batchSize, dtype=torch.int64, device=dev),
                "targetId": torch.tensor(self.targetId, dtype=torch.int32, device=dev),
                "scatterCoefficient": torch.tensor(
                    self.scatterCoefficient, dtype=torch.float32, device=dev
                ),
                "maxTime": torch.tensor(self.maxTime, dtype=torch.float32, device=dev),
            },
            "scene": self.scene.pack,
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
            "guide": self.targetGuide.params(dev),
        }
        return p

    def _propagation(self, p) -> PropagateParams:
        pack: ScenePack = p["scene"]
        extent = pack.upper_bbox - pack.lower_bbox
        return PropagateParams(
            scatter_coefficient=p["tracer"]["scatterCoefficient"],
            lower_bbox=pack.lower_bbox,
            upper_bbox=pack.upper_bbox,
            max_time=p["tracer"]["maxTime"],
            max_dist=torch.sqrt(dot(extent, extent)),
        )

    # -- physics helpers -------------------------------------------------

    def _fresnel(self, pack: ScenePack, ray: RayState, hit: SurfaceHit):
        """(n_in, n_tr, r_s, r_p) per lane
        (reference: shader/scatter.surface.glsl:21-51)."""
        cos_i = torch.clamp(dot(ray.direction, hit.ray_nrm), -1.0, 1.0)
        sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
        n_i = ray.constants.n
        lmin = pack.media.lambda_min[hit.medium_tr]
        lmax = pack.media.lambda_max[hit.medium_tr]
        t = torch.clamp((ray.wavelength - lmin) / (lmax - lmin), 0.0, 1.0)
        n_t = lookup_packed(
            pack.media.tables["refractive_index"],
            pack.media.sizes["refractive_index"],
            hit.medium_tr,
            t,
            1.0,
        )
        sin_t = sin_i * n_i / n_t
        s2 = 1.0 - sin_t * sin_t
        tir = s2 <= 0.0
        cos_t = torch.where(tir, 0.0, torch.sqrt(torch.where(tir, 1.0, s2)))
        cos_i = torch.abs(cos_i)
        r_s = (n_i * cos_i - n_t * cos_t) / (n_i * cos_i + n_t * cos_t)
        r_p = (n_t * cos_i - n_i * cos_t) / (n_t * cos_i + n_i * cos_t)
        return n_i, n_t, r_s, r_p

    def _scatter_prob_packed(self, pack: ScenePack, medium, in_dir, out_dir):
        """Phase function value via the packed log-phase tables."""
        cos_theta = dot(in_dir, out_dir)
        log_p = lookup_packed(
            pack.media.tables["log_phase_function"],
            pack.media.sizes["log_phase_function"],
            medium,
            0.5 * (cos_theta + 1.0),
            _LOG_INV_4PI,
        )
        return torch.exp(log_p), log_p

    def _sample_phase_packed(self, pack: ScenePack, medium, in_dir, u1, u2):
        """Importance sample the phase function from packed tables.
        Returns (direction, pdf, log_p) — uniform-sphere fallback where the
        medium has no sampling table."""
        phi = 2.0 * np.pi * u1
        sizes = pack.media.sizes["phase_sampling"]
        cos_tab = lookup_packed(pack.media.tables["phase_sampling"], sizes, medium, u2, 0.0)
        has_tab = sizes[medium] > 0
        cos_theta = torch.where(
            has_tab, torch.clamp(cos_tab, -1.0, 1.0), 2.0 * u2 - 1.0
        ).detach()
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
        item = create_hit(
            replace(ray, lin_contrib=lin),
            hit.obj_pos, hit.obj_nrm, hit.custom_id, hit.world_to_obj, pol=pol,
        )
        return item, item.contrib > 0.0

    def _propagate_to_hit(self, ray: RayState, hit: SurfaceHit, prop):
        delta = hit.world_pos - ray.position
        dist = torch.sqrt(torch.clamp_min(dot(delta, delta), 1e-30))
        new, code = update_ray(replace(ray, position=hit.world_pos), dist, prop)
        # deterministic connection distance: reattach its gradient
        return reattach_geometry(new, dist), code

    def _shadow_item(self, p, ray: RayState, hit: SurfaceHit, mask, prop, pol=None):
        """processShadowRay's item half: the detector HitItem + validity
        for a (batched) shadow wavefront
        (reference: scene.traverse.glsl:160-183)."""
        pack: ScenePack = p["scene"]
        target_id = p["tracer"]["targetId"]
        is_target = (hit.flags & _DETECTOR) != 0
        correct = (target_id < 0) | (hit.custom_id == target_id)
        ok = mask & hit.valid & is_target & correct & (hit.error == 0)
        moved, code = self._propagate_to_hit(ray, hit, prop)
        ok = ok & (code >= 0)
        n_i, n_t, r_s, r_p = self._fresnel(pack, moved, hit)
        absorb = (hit.flags & _BLACK) != 0
        item, pos_mask = self._create_response_item(
            moved, hit, r_s, r_p, n_i, n_t, absorb, pol=pol
        )
        return item, ok & pos_mask

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
            lin_contrib=src.contrib * lam_contrib,
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
        sg = lambda a: a.detach()

        # health check (reference: scene.traverse.glsl:288-290)
        alive = alive & ~ray.is_bad()
        pre_alive = alive

        # ---- trace() (scene.traverse.glsl:286-352) ----
        uu, rng = rng.uniform()
        dist = sample_scatter_length(ray, prop, uu)
        sampled_dist = dist
        guide_eval = self.targetGuide.eval(p["guide"], ray.position, ray.direction)
        mis_ext = allow_response & (guide_eval.prob > 0.0) & (guide_eval.dist > dist)
        dist = torch.where(mis_ext, torch.maximum(guide_eval.dist, dist), dist)

        hit = intersect_scene(pack, medium, ray.position, ray.direction, dist)
        travel = torch.where(hit.valid, hit.t, dist)

        # a hit beyond the sampled distance is a free shadow ray; its
        # response and the main surface response are per-lane exclusive and
        # share the hit rows, so they fuse into ONE Fresnel + item + record
        # at the main response site
        ext_mask = (
            pre_alive & mis_ext & hit.valid
            & (travel > sampled_dist) & (hit.error == 0)
        )
        ext_ray, ext_code = self._propagate_to_hit(ray, hit, prop)
        ext_ok = ext_mask & (ext_code >= 0)
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
        n_i, n_t, r_s, r_p = self._fresnel(pack, ray, hit)
        flags = hit.flags
        is_abs = (flags & _BLACK) != 0
        is_target = (flags & _DETECTOR) != 0
        vol_border = (flags & _VOLUME) != 0
        can_reflect = (flags & _NO_R_FWD) == 0
        can_transmit = (flags & _NO_T_FWD) == 0

        target_id = p["tracer"]["targetId"]
        correct = (target_id < 0) | (hit.custom_id == target_id)
        respond = surf & allow_response & is_target & correct
        # align the polarization frame perpendicular to the plane of
        # incidence on surface lanes (alignRayToHit); uses the incident
        # direction, so it comes before the new direction is chosen
        if pol is not None:
            pol = _where_pol(surf, _pol_align(ray.direction, pol, hit.ray_nrm), pol)
        # extension lanes respond with their propagated-to-hit state; the
        # masks are disjoint (ext lanes left ``surf`` above). Their frame is
        # the unaligned one, which the response item aligns, as the JAX
        # package's separate extension response does
        resp_ray = _where_ray(ext_ok, ext_ray, ray)
        item, pos_ok = self._create_response_item(
            resp_ray, hit, r_s, r_p, n_i, n_t, is_abs, pol=pol
        )
        rec_mask = (respond | (ext_ok & is_target & correct)) & pos_ok
        resp_state, rng_a = self.response.record(p["response"], resp_state, item, rec_mask, rng)
        rng = _merge_dim(rng_a, rng, rec_mask)

        # surface interaction outcome
        r_coef = 0.5 * (r_s * r_s + r_p * r_p)
        u_surf, rng_a = rng.uniform()
        both = surf & ~is_abs & ~vol_border & can_reflect & can_transmit
        rng = _merge_dim(rng_a, rng, both)
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
        medium = new_medium
        new_c = packed_medium_constants(pack.media, medium, ray.wavelength)
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

        # ---- processInteraction: volume scatter (miss) ----
        if not last:
            miss = pre_alive & in_bounds & ~hit.valid
            resp_state, rng = self._mis_shadow(
                p, pack, prop, ray, medium, miss, pol, rng, resp_state
            )
            # scatter the real ray
            rng_b = rng
            (su1, su2), rng = rng.uniform2d()
            scat_dir, _, scat_log_p = self._sample_phase_packed(
                pack, medium, ray.direction, su1, su2
            )
            scat_corr = scat_log_p - sg(scat_log_p)
            if pol is not None:
                pol = _where_pol(
                    miss, _pol_scatter_packed(pack.media, medium, ray.direction, scat_dir, pol), pol
                )
            ray = replace(
                ray,
                direction=torch.where(miss[..., None], scat_dir, ray.direction),
                lin_contrib=torch.where(
                    miss, ray.lin_contrib * ray.constants.mu_s, ray.lin_contrib
                ),
                log_contrib=torch.where(miss, ray.log_contrib + scat_corr, ray.log_contrib),
            )
            rng = _merge_dim(rng, rng_b, miss)

        # ---- result codes + events ----
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
        alive = pre_alive & (code >= 0) & ~absorbed_surf
        cb_state = self.callback.on_event(p["callback"], cb_state, ray, code, pre_alive, i + 1)
        allow_response = code != int(E.RAY_SCATTERED)
        return ray, medium, alive, allow_response, pol, rng, resp_state, cb_state

    def _mis_shadow(self, p, pack, prop, ray, medium, miss, pol, rng, resp_state):
        """The two MIS shadow rays of a scatter vertex (phase sample and
        guide sample), traced as one 2N-lane query and recorded in one
        call; the RNG dims advance only on ``miss`` lanes. Polarized, each
        shadow ray carries the Stokes vector scattered into its direction."""
        sg = lambda a: a.detach()
        rng_b = rng
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

        tile = lambda a: torch.cat([a, a])
        directions = torch.cat([dir_phase, guide_sample.direction])
        hit2 = intersect_target(
            pack, tile(medium), tile(ray.position), directions,
            torch.cat([phase_eval.dist, guide_sample.dist]),
            active=tile(miss),
        )
        shadow2 = RayState(
            position=tile(ray.position),
            direction=directions,
            wavelength=tile(ray.wavelength),
            time=tile(ray.time),
            lin_contrib=torch.cat([
                ray.lin_contrib * ray.constants.mu_s * sg(w_phase),
                ray.lin_contrib * ray.constants.mu_s * sg(w_target),
            ]),
            log_contrib=torch.cat([
                ray.log_contrib + log_p_pp - sg(log_p_pp),
                ray.log_contrib + log_p_pt - sg(log_p_pt),
            ]),
            constants=_cat_constants(ray.constants),
        )
        pol2 = None
        if pol is not None:
            halves = (
                _pol_scatter_packed(pack.media, medium, ray.direction, d, pol)
                for d in (dir_phase, guide_sample.direction)
            )
            pol2 = tuple(torch.cat(pair) for pair in zip(*halves))
        item2, ok2 = self._shadow_item(p, shadow2, hit2, tile(miss), prop, pol=pol2)
        resp_state, _ = self.response.record(p["response"], resp_state, item2, ok2, rng)
        return resp_state, _merge_dim(rng, rng_b, miss)

    # -- the batch -------------------------------------------------------

    def _trace_batch(self, p, counter, streams):
        pack: ScenePack = p["scene"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)
        ray, medium, pol, rng = self._sample_initial(p, pack, streams, rng)

        resp_state = self.response.init(streams.device)
        cb_state = self.callback.init(streams.shape[0], self.maxPathLength + 2)
        created = torch.full_like(streams, int(EventResultCode.RAY_CREATED))
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, created, active_lanes(streams, p), 0
        )
        alive = active_lanes(streams, p) & ~ray.is_bad()
        allow_response = torch.ones_like(alive)
        carry = (ray, medium, alive, allow_response, pol, rng, resp_state, cb_state)
        for i in range(self.maxPathLength):
            carry = self._segment(p, pack, prop, carry, i, i == self.maxPathLength - 1)
        ray, medium, alive, allow_response, pol, rng, resp_state, cb_state = carry
        max_iter = torch.full_like(streams, int(EventResultCode.MAX_ITER))
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, max_iter, alive, self.maxPathLength + 1
        )
        if self._debug_rng:
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state
