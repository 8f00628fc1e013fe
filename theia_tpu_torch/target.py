"""Target guides: analytic MIS proxies that steer shadow rays toward a
detector (reference: src/theia/target.py:427-527,
shader/target_guide.sphere.glsl). Same sampling as ``theia_tpu.target``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import units as u
from .component import Component
from .ops.math3d import distance, dot, local_frame, normalize
from .random import RNGState

__all__ = ["TargetGuideSample", "TargetGuide", "SphereTargetGuide"]


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
        cos_min = 1.0 - torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
        # Taylor fallback for narrow cones (f32 catastrophic cancellation)
        cos_min = torch.where(sin2 < 0.00068523, 0.5 * sin2, cos_min)
        prob = 1.0 / (2.0 * np.pi * cos_min)
        prob = prob * (d > params["radius"]).to(torch.float32)
        return view_dir, cos_min, prob, d + params["radius"]

    def sample(self, params, observer, rng: RNGState):
        view_dir, cos_min, prob, dist = self._cone(params, observer)
        (u1, u2), rng = rng.uniform2d()
        cos_theta = 1.0 - cos_min * u1
        sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
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
