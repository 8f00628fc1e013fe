"""Volume tracers: analytic targets, single (possibly scattering) medium.

The port of ``theia_tpu.trace.volume.VolumeForwardTracer``: forward path
tracing in one homogeneous medium against an analytic target, with
exponential distance sampling, MIS between phase-function and target
sampling, and time-resolved responses (reference:
src/theia/trace.py:499-770, shader/tracer.volume.forward.glsl). A
wavefront of lanes with alive masks runs the segments; each lane's RNG
dim counter advances only where the reference's control flow draws,
exactly as ``theia_tpu`` advances it, so the same Philox streams give
the same paths. Path geometry is detached, physical factors stay
attached and sampling pdfs and MIS weights are frozen, as ``theia_tpu``
does with ``stop_gradient``.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from .. import units as u
from ..callback import EmptyEventCallback, TraceEventCallback
from ..component import Component, TraceConfig, resolve_device
from ..light import LightSource, WavelengthSource
from ..lookup import lookup
from ..material import Medium, medium_constants
from ..ops.math3d import dot, local_frame, normalize, sqrt
from ..ops.sampling import scatter_dir
from ..ops.table_read import PHASE
from ..polarization import (
    apply_phase_matrix,
    apply_rotation,
    phase_matrix_elements,
    rotate_pol_ref,
    unpolarized_stokes,
)
from ..random import PhiloxRNG, RNGState
from ..target import Target, TargetSample
from .core import (
    EventResultCode,
    PropagateParams,
    RayState,
    TracerBase,
    active_lanes,
    create_hit,
    merge_dim,
    propagate_ray,
    propagate_ray_to_hit,
    reattach_geometry,
    sample_scatter_dir_medium,
    sample_scatter_length,
    scatter_prob,
    scatter_ray_is,
    select_ray,
    update_ray_is,
)

__all__ = ["VolumeForwardTracer"]


def _jacobian_dA_dW(obs, pos, nrm):
    """Area -> solid-angle probability conversion; 0 marks invalid
    (reference: tracer.volume.forward.glsl:107-118)."""
    d = pos - obs
    factor = dot(d, d) / torch.abs(dot(normalize(d), nrm))
    return torch.where(torch.isinf(factor) | torch.isnan(factor), 0.0, factor)


def _log_phase(medium: Medium | None, cos_theta):
    if medium is None or medium.log_phase_function is None:
        return None
    return lookup(medium.log_phase_function, cos_theta, affine=PHASE)


def _pol_scatter(medium, direction, new_dir, pol):
    """Polarized scatter: rotate the frame into the scattering plane and
    apply the Mueller phase matrix (reference: ray.scatter.glsl:50-62)."""
    stokes, pol_ref = pol
    m12, m22, m33, m34 = phase_matrix_elements(medium, dot(direction, new_dir))
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, new_dir)
    return apply_phase_matrix(apply_rotation(stokes, c, s), m12, m22, m33, m34), new_ref


def _pol_align(direction, pol, hit_normal):
    """Rotate the frame into the plane of incidence
    (reference: ray.propagate.glsl alignRayToHit)."""
    stokes, pol_ref = pol
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, hit_normal)
    return apply_rotation(stokes, c, s), new_ref


class VolumeForwardTracer(TracerBase):
    """Forward path tracing in a single homogeneous medium against an
    analytic target (reference: src/theia/trace.py:499-770).

    ``medium``: a :class:`~theia_tpu_torch.material.Medium` (or None =
    vacuum); :meth:`params` puts its tables on ``device`` as tensors,
    which a caller may replace with tensors that require a gradient. Lanes
    and parameters live on ``device``: the card unless the caller names
    another; without a card the default raises."""

    name = "Volume Forward Tracer"
    _param_names = ("scatterCoefficient", "objectId", "maxTime")
    _extra_names = ("medium", "traceBBox")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        target: Target,
        wavelengthSource: WavelengthSource,
        response,
        rng: PhiloxRNG,
        *,
        medium: Medium | None,
        objectId: int = 0,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        nScattering: int = 6,
        scatterCoefficient: float = float("nan"),
        traceBBox: tuple = ((-1.0 * u.km,) * 3, (1.0 * u.km,) * 3),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
        disableTargetSampling: bool = False,
        refCompatRNG: bool = False,
        device="cuda",
    ) -> None:
        if not source.supportForward:
            raise ValueError("light source does not support forward mode")
        self.device = resolve_device(device)
        self._init_batch(batchSize, capacity)
        self.source = source
        self.target = target
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.medium = medium
        self.objectId = objectId
        self.callback = EmptyEventCallback() if callback is None else callback
        self.nScattering = nScattering
        self.scatterCoefficient = scatterCoefficient
        self.traceBBox = traceBBox
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting
        self.disableTargetSampling = disableTargetSampling

        # the draw budget as theia_tpu.trace.volume counts it: the pre-loop
        # first step (dist 1, plus phase 2 + target draws under MIS) that
        # the reference's stride * pathLength leaves out is counted;
        # refCompatRNG=True advances as the reference does (stride 3 or 7,
        # no first step), overlapping Philox streams between batches
        self.refCompatRNG = refCompatRNG
        self.maxHitsPerThread = nScattering
        if not disableTargetSampling:
            self.maxHitsPerThread *= 2
        if not disableDirectLighting:
            self.maxHitsPerThread += 1
        self.pathLength = nScattering if disableTargetSampling else nScattering - 1
        if refCompatRNG:
            firstStep = 0
            rngStride = 3 if disableTargetSampling else 7
        elif disableTargetSampling:
            firstStep = 1
            rngStride = 3
        else:
            firstStep = 3 + target.nRNGSamples
            rngStride = 5 + target.nRNGSamples
        self.nRNGSamples = (
            source.nRNGForward
            + wavelengthSource.nRNGSamples
            + firstStep
            + rngStride * self.pathLength
            + self.maxHitsPerThread * response.nRNGSamples
        )
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=self.batchSize,
                capacity=self.capacity,
                max_hits_per_thread=self.maxHitsPerThread,
                normalization=self.normalization,
                polarized=self.polarized,
            )
        )

    def collectStages(self) -> list[tuple[str, Component]]:
        return [
            ("photons", self.wavelengthSource),
            ("lightSource", self.source),
            ("target", self.target),
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
                "lowerBBox": f32(self.traceBBox[0]),
                "upperBBox": f32(self.traceBBox[1]),
                "objectId": torch.tensor(self.objectId, dtype=torch.int32, device=dev),
            },
            "medium": None if self.medium is None else self.medium.to(dev),
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "target": self.target.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
        }

    # -- the batch -------------------------------------------------------

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

    def _create_response(
        self, p, resp_state, ray: RayState, hit: TargetSample, direction, w_frozen, w_traced,
        scattered: bool, mask, rng: RNGState, prop, medium=None, pol=None,
    ):
        """Propagate a copy of the ray to a target sample and record the
        response (reference: tracer.volume.forward.glsl:50-80); the
        response's draws stay on recorded lanes. Returns (resp_state, rng)."""
        valid = mask & hit.valid
        if pol is not None and scattered:
            pol = _pol_scatter(medium, ray.direction, direction, pol)
        if scattered:
            ray = scatter_ray_is(ray, direction)
        if pol is not None:
            pol = _pol_align(direction if scattered else ray.direction, pol, hit.normal)
        ray, code = propagate_ray_to_hit(ray, hit.position, prop)
        valid = valid & (code >= 0)
        ray = replace(ray, lin_contrib=ray.lin_contrib * w_frozen.detach())
        if w_traced is not None:
            ray = replace(ray, log_contrib=ray.log_contrib + w_traced - w_traced.detach())
        item = create_hit(
            ray, hit.obj_position, hit.obj_normal, p["tracer"]["objectId"], hit.world_to_obj, pol=pol
        )
        valid = valid & (item.contrib > 0.0)
        resp_state, rng_after = self.response.record(p["response"], resp_state, item, valid, rng)
        return resp_state, merge_dim(rng_after, rng, valid)

    def _trace_step(self, p, prop, medium, ray, alive, rng, resp_state, allow_response: bool, pol=None):
        """One path segment (reference: tracer.volume.forward.glsl:152-211).
        Returns (ray, alive, rng, resp_state, code, pol)."""
        E = EventResultCode
        uu, rng = rng.uniform()
        dist = sample_scatter_length(ray, prop, uu)

        hit = self.target.intersect(p["target"], ray.position, ray.direction)
        hit_valid = hit.valid & (hit.dist <= dist)
        dist = torch.minimum(hit.dist, dist)

        ray, code = propagate_ray(ray, dist, prop)
        # the geometric target distance carries d/d(geometry)
        ray = reattach_geometry(ray, dist, valid=hit_valid)
        ray = update_ray_is(ray, dist, prop, hit_valid)
        in_bounds = code >= 0

        # lanes hitting the target are done: DETECTED with a response when
        # allowed, silently ABSORBED otherwise
        stop = int(E.RAY_DETECTED if allow_response else E.RAY_ABSORBED)
        code = torch.where(in_bounds & hit_valid, stop, code).to(torch.int32)
        mis_mask = alive & in_bounds & ~hit_valid
        if not self.disableTargetSampling:
            # MIS: sample both the phase function and the target
            # (reference: tracer.volume.forward.glsl:120-150); with MIS the
            # reference records no plain target hit, so the two candidates
            # are the only responses
            sg = lambda a: a.detach()
            rng_before = rng
            (u1, u2), rng = rng.uniform2d()
            cos_theta, phi, p_pp = sample_scatter_dir_medium(medium, ray.direction, ray.wavelength, u1, u2)
            dir_phase = scatter_dir(ray.direction, sg(cos_theta), phi)
            phase_hit = self.target.intersect(p["target"], ray.position, dir_phase)

            target_hit, rng = self.target.sample(p["target"], ray.position, rng)
            dir_target = normalize(target_hit.position - ray.position)
            p_tt = target_hit.prob * _jacobian_dA_dW(ray.position, target_hit.position, target_hit.normal)
            p_pt = scatter_prob(medium, ray.direction, dir_target)
            p_tp = phase_hit.prob * _jacobian_dA_dW(ray.position, phase_hit.position, phase_hit.normal)
            # frozen MIS weights; the physical factors come back through the
            # log-ratio terms
            w_target = sg(p_tt) * sg(p_pt) / (sg(p_tt) ** 2 + sg(p_pt) ** 2)
            w_phase = sg(p_pp) ** 2 / (sg(p_pp) ** 2 + sg(p_tp) ** 2)
            # a grazing lane on the target overflows p_tt and makes the
            # weight inf/inf; the reference drops it by its contrib > 0 test
            w_target = torch.nan_to_num(w_target, nan=0.0, posinf=0.0, neginf=0.0)
            w_phase = torch.nan_to_num(w_phase, nan=0.0, posinf=0.0, neginf=0.0)
            log_p_pt = _log_phase(medium, dot(ray.direction, dir_target))
            log_p_pp = _log_phase(medium, sg(cos_theta))
            for cand, direction, w, w_log in (
                (phase_hit, dir_phase, w_phase, log_p_pp),
                (target_hit, dir_target, w_target, log_p_pt),
            ):
                resp_state, rng = self._create_response(
                    p, resp_state, ray, cand, direction, w, w_log, True, mis_mask, rng, prop,
                    medium=medium, pol=pol,
                )
            # lanes that hit (or died) did not draw for MIS
            rng = merge_dim(rng, rng_before, mis_mask)
        elif allow_response:
            hit_pol = None if pol is None else _pol_align(ray.direction, pol, hit.normal)
            item = create_hit(
                ray, hit.obj_position, hit.obj_normal, p["tracer"]["objectId"], hit.world_to_obj, pol=hit_pol
            )
            mask = alive & in_bounds & hit_valid & (item.contrib > 0.0)
            resp_state, rng_after = self.response.record(p["response"], resp_state, item, mask, rng)
            rng = merge_dim(rng_after, rng, mask)

        code = torch.where(mis_mask, int(E.RAY_SCATTERED), code).to(torch.int32)
        alive = alive & (code >= 0) & ~(in_bounds & hit_valid)
        return ray, alive, rng, resp_state, code, pol

    def _trace_batch(self, p, counter, streams):
        """Sample, the first segment, then the scattering segments
        (reference: tracer.volume.forward.glsl:231-276)."""
        E = EventResultCode
        medium = p["medium"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)

        # sampleRay (tracer.volume.forward.glsl:222-228)
        (lam, lam_contrib), rng = self.wavelengthSource.sample(p["photons"], rng)
        constants = medium_constants(medium, lam)
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

        resp_state = self.response.init(streams.device)
        cb_state = self.callback.init(streams.shape[0], self.pathLength + 3, streams.device)
        all_lanes = active_lanes(streams, p)

        def on_event(state, code, mask, i):
            # the current ray and frame; a code given as an enum goes to every lane
            if isinstance(code, E):
                code = torch.full_like(streams, int(code))
            return self.callback.on_event(p["callback"], state, ray, code, mask, i, pol=pol)

        cb_state = on_event(cb_state, E.RAY_CREATED, all_lanes, 0)
        occluded = self.target.occluded(p["target"], ray.position)
        cb_state = on_event(cb_state, E.ERROR_TRACE_ABORT, occluded & all_lanes, 0)
        alive = all_lanes & ~occluded & ~ray.is_bad()

        mis = not self.disableTargetSampling
        direct = not self.disableDirectLighting
        if direct and mis:
            # extend the first ray to the target (tracer.volume.forward.glsl:250-253)
            direct_hit = self.target.intersect(p["target"], ray.position, ray.direction)
            resp_state, rng = self._create_response(
                p, resp_state, ray, direct_hit, ray.direction, torch.ones_like(lam), None, False,
                alive, rng, prop, medium=medium, pol=pol,
            )

        # the first trace responds directly only without MIS (with MIS the
        # unscattered segment was handled by the extension above)
        pre_alive = alive
        ray, alive, rng, resp_state, code, pol = self._trace_step(
            p, prop, medium, ray, alive, rng, resp_state, (not mis) and direct, pol
        )
        cb_state = on_event(cb_state, code, pre_alive, 1)

        for i in range(self.pathLength):
            pre_alive = alive
            # scatter (2 draws), then trace
            rng_b = rng
            (u1, u2), rng = rng.uniform2d()
            cos_theta, phi, _ = sample_scatter_dir_medium(medium, ray.direction, ray.wavelength, u1, u2)
            cos_theta = cos_theta.detach()
            new_dir = scatter_dir(ray.direction, cos_theta, phi)
            if pol is not None:
                new_pol = _pol_scatter(medium, ray.direction, new_dir, pol)
                pol = tuple(torch.where(alive[..., None], n, o) for n, o in zip(new_pol, pol))
            scattered = scatter_ray_is(ray, new_dir)
            log_p = _log_phase(medium, cos_theta)
            if log_p is not None:
                scattered = replace(
                    scattered, log_contrib=scattered.log_contrib + log_p - log_p.detach()
                )
            ray = select_ray(alive, scattered, ray)
            rng = merge_dim(rng, rng_b, alive)

            ray, alive, rng, resp_state, code, pol = self._trace_step(
                p, prop, medium, ray, alive, rng, resp_state, not mis, pol
            )
            cb_state = on_event(cb_state, code, pre_alive, i + 2)

        cb_state = on_event(cb_state, E.MAX_ITER, alive, self.pathLength + 2)
        if self._debug_rng:
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state
