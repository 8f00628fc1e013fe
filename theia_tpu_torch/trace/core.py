"""Shared ray-state machinery for the tracers.

The wavefront of N photons is a set of (N,)-shaped tensors; every function
here is a pure tensor transform on it. Semantics mirror
``theia_tpu.trace.core`` (reference: src/theia/shader/ray.glsl:22-143,
ray.propagate.glsl:32-166, result.glsl:10-29). Sampling-probability
factors are detached while physical factors stay attached, as the JAX
package wraps them in ``stop_gradient``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum

import torch

from ..component import Component
from ..lookup import lookup
from ..material import Medium, MediumConstants
from ..ops.math3d import dot, matvec, normalize, perpendicular_to2, sqrt
from ..ops.sampling import INV_4PI, TWO_PI, scatter_dir
from ..ops.table_read import PHASE
from ..polarization import apply_rotation, rotation_coeffs

__all__ = [
    "EventResultCode",
    "TracerBase",
    "active_lanes",
    "PropagateParams",
    "RayState",
    "sample_scatter_length",
    "update_ray",
    "update_ray_is",
    "propagate_ray",
    "propagate_ray_to_hit",
    "reattach_geometry",
    "merge_dim",
    "select_ray",
    "sample_scatter_dir_medium",
    "scatter_prob",
    "scatter_ray",
    "scatter_ray_is",
    "scatter_ray_sampled",
    "create_hit",
    "HitItem",
]


class EventResultCode(IntEnum):
    """Result codes emitted after each trace step
    (reference: src/theia/shader/result.glsl:10-29, trace.py:308-343)."""

    SUCCESS = 0
    RAY_CREATED = 1
    RAY_SCATTERED = 2
    RAY_HIT = 3
    RAY_DETECTED = 4
    VOLUME_HIT = 5
    RAY_LOST = -1
    RAY_DECAYED = -2
    RAY_ABSORBED = -3
    RAY_MISSED = -4
    MAX_ITER = -5
    ERROR_CODE_MAX_VALUE = -10
    ERROR_UNKNOWN = -10
    ERROR_MEDIA_MISMATCH = -11
    ERROR_TRACE_ABORT = -12
    ERROR_RAY_BAD = -13


def active_lanes(streams: torch.Tensor, p) -> torch.Tensor:
    """Mask of lanes that belong to the current batch: lanes with
    ``stream >= batchSize`` are dead from creation, so ``batchSize`` can
    change per batch below the allocated capacity."""
    bs = p.get("tracer", {}).get("batchSize") if isinstance(p, dict) else None
    if bs is None:
        return torch.ones(streams.shape, dtype=torch.bool, device=streams.device)
    return streams < bs


class TracerBase(Component):
    """Host-side batch API shared by every tracer.

    Lanes are allocated at ``capacity``; ``batchSize`` is a runtime
    parameter (lanes beyond it are masked dead, see :func:`active_lanes`)
    and the ``1/batchSize`` normalization follows it."""

    #: conformance hook: when set, ``_trace_batch`` additionally returns
    #: each lane's final RNG dim counter
    _debug_rng: bool = False

    def _init_batch(self, batchSize: int, capacity: int | None) -> None:
        capacity = batchSize if capacity is None else capacity
        if not 0 < batchSize <= capacity:
            raise ValueError(
                f"batchSize must be in (0, capacity={capacity}], got {batchSize}"
            )
        self.batchSize = batchSize
        self.capacity = capacity
        self.normalization = 1.0 / batchSize

    def setParams(self, **kwargs) -> None:
        if "batchSize" in kwargs:
            bs = int(kwargs.pop("batchSize"))
            if not 0 < bs <= self.capacity:
                raise ValueError(
                    f"batchSize must be in (0, capacity={self.capacity}], got {bs}"
                )
            self.batchSize = bs
            self.normalization = 1.0 / bs
            response = getattr(self, "response", None)
            if response is not None:
                response.renormalize(self.normalization)
        super().setParams(**kwargs)

    def getParam(self, name: str):
        if name == "batchSize":
            return self.batchSize
        return super().getParam(name)

    def streams(self) -> torch.Tensor:
        """Lane ids for one batch — always ``capacity`` wide (int32)."""
        return torch.arange(self.capacity, dtype=torch.int32, device=self.device)

    def trace_fn(self):
        """Return ``(fn, (params, counter, streams))`` with
        ``fn(params, counter, streams) -> (response_state, callback_state)``,
        the raw step of one batch with autograd left on, so a caller can
        differentiate its result with respect to tensors it patched into
        ``params`` (``theia_tpu``'s ``trace_fn`` for ``jax.grad``). Unlike
        :meth:`run` it neither advances the RNG nor normalizes."""
        return self._trace_batch, (self.params(), self.rng.counter_words, self.streams())

    def run(self, params=None, *, advance: bool = True):
        """Trace one batch; returns (response result, callback result).

        Advances the RNG offset by nRNGSamples afterwards (the reference's
        autoAdvance, src/theia/random.py:278-282). Runs without autograd:
        the forward light curve takes no gradient."""
        p = self.params() if params is None else params
        with torch.no_grad():
            out = self._trace_batch(p, self.rng.counter_words, self.streams())
        if advance:
            self.rng.advance()
        return (
            self.response.result(p["response"], out[0]),
            self.callback.result(p["callback"], out[1]),
        )


@dataclass(frozen=True)
class PropagateParams:
    """Propagation bounds and the distance-sampling coefficient
    (reference: src/theia/shader/ray.propagate.glsl:20-28).

    ``scatter_coefficient``: negative/NaN -> importance sample with the
    medium's mu_s; zero disables volume scattering."""

    scatter_coefficient: torch.Tensor
    lower_bbox: torch.Tensor  # f32[3]
    upper_bbox: torch.Tensor  # f32[3]
    max_time: torch.Tensor
    max_dist: torch.Tensor


@dataclass(frozen=True)
class RayState:
    """Per-lane ray state; contribution = lin_contrib * exp(log_contrib)."""

    position: torch.Tensor  # f32[N,3]
    direction: torch.Tensor  # f32[N,3]
    wavelength: torch.Tensor  # f32[N]
    time: torch.Tensor  # f32[N]
    lin_contrib: torch.Tensor  # f32[N]
    log_contrib: torch.Tensor  # f32[N]
    constants: MediumConstants  # per-lane

    @property
    def contrib(self) -> torch.Tensor:
        """lin * exp(log), computed in log space with the combined exponent
        clamped to [-87, 87] so extreme lanes stay finite."""
        mag = torch.abs(self.lin_contrib)
        mag_safe = torch.where(mag > 0, mag, 1.0)
        log_total = torch.clamp(torch.log(mag_safe) + self.log_contrib, -87.0, 87.0)
        value = torch.sign(self.lin_contrib) * torch.exp(log_total)
        return torch.where(mag > 0, value, 0.0)

    def is_bad(self) -> torch.Tensor:
        """NaN/inf guard (reference: ray.glsl:136-143)."""
        bad_pos = torch.any(~torch.isfinite(self.position), dim=-1)
        bad_dir = torch.any(~torch.isfinite(self.direction), dim=-1)
        zero_dir = dot(self.direction, self.direction) <= 0.0
        return bad_pos | bad_dir | zero_dir


def _effective_sample_coef(
    params: PropagateParams, constants: MediumConstants
) -> torch.Tensor:
    """Negative/NaN scatter_coefficient selects the medium's mu_s."""
    coef = params.scatter_coefficient
    use_medium = ~(coef >= 0.0)  # catches negatives AND NaN
    return torch.where(use_medium, constants.mu_s, coef)


def sample_scatter_length(
    ray: RayState, params: PropagateParams, u: torch.Tensor
) -> torch.Tensor:
    """Exponential distance sampling; non-scattering media travel max_dist
    (reference: ray.propagate.glsl:32-49)."""
    coef = _effective_sample_coef(params, ray.constants).detach()
    sample = (coef != 0.0) & (ray.constants.mu_s > 0.0)
    safe = torch.where(sample, coef, 1.0)
    dist = -torch.log1p(-u) / safe
    return torch.where(sample, dist, params.max_dist)


def update_ray(
    ray: RayState, dist: torch.Tensor, params: PropagateParams
) -> tuple[RayState, torch.Tensor]:
    """Attenuate and advance time as if traveled ``dist`` (position
    unchanged); returns (ray, result_code) with DECAYED past max_time
    (reference: ray.propagate.glsl:70-80)."""
    d = dist.detach()
    new = replace(
        ray,
        log_contrib=ray.log_contrib - ray.constants.mu_e * d,
        time=ray.time + d / ray.constants.vg,
    )
    code = torch.where(
        new.time <= params.max_time,
        int(EventResultCode.SUCCESS),
        int(EventResultCode.RAY_DECAYED),
    ).to(torch.int32)
    return new, code


def update_ray_is(
    ray: RayState, dist: torch.Tensor, params: PropagateParams, hit: torch.Tensor
) -> RayState:
    """Apply the 1/pdf factor of exponential distance sampling: on a hit the
    exp(+coef*d) survival factor alone; on a miss additionally 1/coef
    (reference: ray.propagate.glsl:101-130). Detached: a sampling factor."""
    coef = _effective_sample_coef(params, ray.constants).detach()
    d = dist.detach()
    can_scatter = ray.constants.mu_s > 0.0
    log_is = torch.where(can_scatter, coef * d, 0.0)
    inv = 1.0 / torch.where(coef > 0.0, coef, 1.0)
    lin_is = torch.where(can_scatter & ~hit, inv, 1.0)
    return replace(
        ray,
        log_contrib=ray.log_contrib + log_is,
        lin_contrib=ray.lin_contrib * lin_is,
    )


def propagate_ray(
    ray: RayState, dist: torch.Tensor, params: PropagateParams
) -> tuple[RayState, torch.Tensor]:
    """Move the ray; RAY_LOST outside the trace bbox
    (reference: ray.propagate.glsl:153-166)."""
    pos = ray.position + dist.detach()[..., None] * ray.direction
    outside = torch.any((pos < params.lower_bbox) | (pos > params.upper_bbox), dim=-1)
    new, code = update_ray(replace(ray, position=pos), dist, params)
    code = torch.where(outside, int(EventResultCode.RAY_LOST), code).to(torch.int32)
    return new, code


def reattach_geometry(
    ray: RayState, dist: torch.Tensor, valid: torch.Tensor | None = None
) -> RayState:
    """Re-attach a *deterministic* distance's gradient to arrival time and
    transmittance via the zero-valued ``dist - dist.detach()``. Call it
    only for geometric distances, never for sampled ones."""
    dt = dist - dist.detach()
    if valid is not None:
        dt = torch.where(valid, dt, 0.0)
    return replace(
        ray,
        time=ray.time + dt / ray.constants.vg,
        log_contrib=ray.log_contrib - ray.constants.mu_e * dt,
    )


def propagate_ray_to_hit(
    ray: RayState, hit_pos: torch.Tensor, params: PropagateParams
) -> tuple[RayState, torch.Tensor]:
    """Propagate to a known hit position (reference:
    ray.propagate.glsl:245-258). The distance to a known hit is
    geometric, so its gradient is re-attached."""
    delta = hit_pos - ray.position
    dist = sqrt(dot(delta, delta))
    new, code = update_ray(replace(ray, position=hit_pos), dist, params)
    return reattach_geometry(new, dist), code


def merge_dim(after, before, take_after: torch.Tensor):
    """``before`` (an ``RNGState``) with the dims of ``after`` on the lanes
    of ``take_after``: a lane's dim advances only where the reference's
    control flow would have drawn, though the wavefront drew everywhere."""
    return replace(before, dim=torch.where(take_after, after.dim, before.dim))


def select_ray(mask: torch.Tensor, a: RayState, b: RayState) -> RayState:
    """Per lane, ``a`` where ``mask`` else ``b``, every field."""
    pick = lambda x, y: torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y)
    return RayState(
        position=pick(a.position, b.position),
        direction=pick(a.direction, b.direction),
        wavelength=pick(a.wavelength, b.wavelength),
        time=pick(a.time, b.time),
        lin_contrib=pick(a.lin_contrib, b.lin_contrib),
        log_contrib=pick(a.log_contrib, b.log_contrib),
        constants=MediumConstants(
            *(pick(getattr(a.constants, f), getattr(b.constants, f)) for f in ("n", "vg", "mu_s", "mu_e"))
        ),
    )


# ------------------------------ volume scattering ---------------------------


def sample_scatter_dir_medium(medium: Medium | None, in_dir, wavelength, u1, u2):
    """Importance sample the phase function; returns (cos_theta, phi, pdf).
    With no sampling table: uniform sphere (reference:
    scatter.volume.glsl:30-47). ``medium`` holds tensors (:meth:`Medium.to`)."""
    phi = TWO_PI * u1
    if medium is not None and medium.phase_sampling is not None:
        cos_theta = torch.clamp(lookup(medium.phase_sampling, u2), -1.0, 1.0)
        pdf = torch.exp(lookup(medium.log_phase_function, cos_theta, affine=PHASE))
    else:
        cos_theta = 2.0 * u2 - 1.0
        pdf = torch.full_like(cos_theta, INV_4PI)
    return cos_theta, phi, pdf


def scatter_prob(medium: Medium | None, in_dir, out_dir) -> torch.Tensor:
    """Phase-function value for the given direction pair
    (reference: scatter.volume.glsl:56-68)."""
    if medium is None or medium.log_phase_function is None:
        return torch.full(in_dir.shape[:-1], INV_4PI, dtype=torch.float32, device=in_dir.device)
    cos_theta = dot(in_dir, out_dir)
    return torch.exp(lookup(medium.log_phase_function, cos_theta, affine=PHASE))


def scatter_ray_is(ray: RayState, new_dir: torch.Tensor) -> RayState:
    """Scatter into an importance-sampled direction: only the scattering
    coefficient is applied, the phase function cancels against its pdf
    (reference: ray.scatter.glsl:13-18)."""
    return replace(ray, direction=new_dir, lin_contrib=ray.lin_contrib * ray.constants.mu_s)


def scatter_ray(ray: RayState, medium: Medium | None, new_dir: torch.Tensor) -> RayState:
    """Scatter into an arbitrary direction: phase function and mu_s
    (reference: ray.scatter.glsl:24-30)."""
    phase = scatter_prob(medium, ray.direction, new_dir)
    return replace(
        ray, direction=new_dir, lin_contrib=ray.lin_contrib * ray.constants.mu_s * phase
    )


def scatter_ray_sampled(ray: RayState, medium: Medium | None, u1, u2) -> RayState:
    """Importance-sampled scatter (reference: ray.scatter.glsl:36-44). The
    phase/pdf ratio is 1 in value but carries the phase function's
    gradient with respect to the medium (the sampled angle is detached)."""
    cos_theta, phi, _ = sample_scatter_dir_medium(medium, ray.direction, ray.wavelength, u1, u2)
    cos_theta = cos_theta.detach()
    ray = scatter_ray_is(ray, scatter_dir(ray.direction, cos_theta, phi).detach())
    if medium is not None and medium.log_phase_function is not None:
        log_p = lookup(medium.log_phase_function, cos_theta, affine=PHASE)
        ray = replace(ray, log_contrib=ray.log_contrib + log_p - log_p.detach())
    return ray


# ------------------------------ hits ----------------------------------------


@dataclass(frozen=True)
class HitItem:
    """Detector hit in object space
    (reference: src/theia/shader/response.common.glsl:4-20).
    ``stokes``/``pol_ref`` present only in polarized mode."""

    position: torch.Tensor  # f32[N,3] object space
    direction: torch.Tensor  # f32[N,3] object space
    normal: torch.Tensor  # f32[N,3] object space
    wavelength: torch.Tensor  # f32[N]
    time: torch.Tensor  # f32[N]
    contrib: torch.Tensor  # f32[N]
    object_id: torch.Tensor  # i32[N]
    stokes: torch.Tensor | None = None  # f32[N,4] normalized
    pol_ref: torch.Tensor | None = None  # f32[N,3] object space


def create_hit(
    ray: RayState,
    obj_pos: torch.Tensor,
    obj_normal: torch.Tensor,
    object_id,
    world_to_obj: torch.Tensor | None = None,
    pol: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> HitItem:
    """Build a HitItem from the ray's current state
    (reference: src/theia/shader/ray.response.glsl:18-92).

    ``pol=(stokes, pol_ref)`` in world space enables the polarized variant:
    the reference frame is transformed to object space, aligned to the
    plane of incidence, and S0 is folded into the contribution."""
    if world_to_obj is None:
        obj_dir = ray.direction
    else:
        obj_dir = normalize(matvec(world_to_obj, ray.direction))
    object_id = torch.broadcast_to(
        torch.as_tensor(object_id, dtype=torch.int32, device=ray.wavelength.device),
        ray.wavelength.shape,
    )
    contrib = ray.contrib
    stokes = pol_ref = None
    if pol is not None:
        w_stokes, w_ref = pol
        hit_pol_ref = perpendicular_to2(obj_dir, obj_normal)
        if world_to_obj is None:
            obj_pol_ref = w_ref
        else:
            obj_pol_ref = normalize(matvec(world_to_obj, w_ref))
        c, s = rotation_coeffs(obj_dir, obj_pol_ref, hit_pol_ref)
        stokes = apply_rotation(w_stokes, c, s)
        s0 = stokes[..., 0]
        contrib = contrib * s0
        # the guard keeps a zero-intensity lane finite: 0/0 there would
        # poison every gradient through the wavefront
        safe = torch.where(s0 != 0.0, s0, 1.0)
        stokes = stokes / safe[..., None]
        pol_ref = hit_pol_ref
    return HitItem(
        position=obj_pos,
        direction=obj_dir,
        normal=obj_normal,
        wavelength=ray.wavelength,
        time=ray.time,
        contrib=contrib,
        object_id=object_id,
        stokes=stokes,
        pol_ref=pol_ref,
    )
