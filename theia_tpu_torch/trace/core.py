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
from ..material import MediumConstants
from ..ops.math3d import dot, matvec, normalize

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
    "reattach_geometry",
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


@dataclass(frozen=True)
class HitItem:
    """Detector hit in object space
    (reference: src/theia/shader/response.common.glsl:4-20)."""

    position: torch.Tensor  # f32[N,3] object space
    direction: torch.Tensor  # f32[N,3] object space
    normal: torch.Tensor  # f32[N,3] object space
    wavelength: torch.Tensor  # f32[N]
    time: torch.Tensor  # f32[N]
    contrib: torch.Tensor  # f32[N]
    object_id: torch.Tensor  # i32[N]


def create_hit(
    ray: RayState,
    obj_pos: torch.Tensor,
    obj_normal: torch.Tensor,
    object_id,
    world_to_obj: torch.Tensor | None = None,
) -> HitItem:
    """Build a HitItem from the ray's current state, unpolarized
    (reference: src/theia/shader/ray.response.glsl:18-92)."""
    if world_to_obj is None:
        obj_dir = ray.direction
    else:
        obj_dir = normalize(matvec(world_to_obj, ray.direction))
    object_id = torch.broadcast_to(
        torch.as_tensor(object_id, dtype=torch.int32, device=ray.wavelength.device),
        ray.wavelength.shape,
    )
    return HitItem(
        position=obj_pos,
        direction=obj_dir,
        normal=obj_normal,
        wavelength=ray.wavelength,
        time=ray.time,
        contrib=ray.contrib,
        object_id=object_id,
    )
