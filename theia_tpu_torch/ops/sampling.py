"""Direction sampling helpers (same mappings as ``theia_tpu.ops.sampling``,
reference: src/theia/shader/util.sample.glsl:6-95), so identical Philox
streams yield identical samples."""

from __future__ import annotations

import torch

from .math3d import local_frame, normalize, sqrt, vec3

__all__ = [
    "spherical_to_cartesian",
    "sample_direction_cone",
    "sample_unit_sphere",
    "sample_unit_disk",
    "sample_hemisphere",
    "sample_hemisphere_cosine",
    "sample_hemisphere_cosine_pdf",
    "scatter_dir",
    "TWO_PI",
    "FOUR_PI",
    "INV_PI",
    "INV_4PI",
]

TWO_PI = 6.283185307179586477
FOUR_PI = 12.56637061435917295
INV_PI = 0.318309886183790672
INV_4PI = 0.0795774715459476679
PI_OVER_TWO = 1.570796326794896619
PI_OVER_FOUR = 0.7853981633974483096


def spherical_to_cartesian(phi, cos_theta) -> torch.Tensor:
    """Note the reference's (sin, cos) convention: x = sinθ·sinφ, y = sinθ·cosφ."""
    sin_theta = sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return vec3(sin_theta * torch.sin(phi), sin_theta * torch.cos(phi), cos_theta)


def sample_direction_cone(cos_opening, u1, u2) -> torch.Tensor:
    """Uniform direction in the cone around +z with opening cosine."""
    cos_theta = (1.0 - u2) + cos_opening * u2
    return spherical_to_cartesian(TWO_PI * u1, cos_theta)


def sample_unit_sphere(u1, u2) -> torch.Tensor:
    phi = TWO_PI * u1
    cos_theta = 2.0 * u2 - 1.0
    return spherical_to_cartesian(phi, cos_theta)


def sample_unit_disk(u1, u2) -> torch.Tensor:
    """Concentric disk sampling (PBRT A.5); z = 0."""
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    safe_x = torch.where(x == 0.0, 1.0, x)
    safe_y = torch.where(y == 0.0, 1.0, y)
    phi = torch.where(
        use_x, PI_OVER_FOUR * (y / safe_x), PI_OVER_TWO - PI_OVER_FOUR * (x / safe_y)
    )
    r = torch.where((x == 0.0) & (y == 0.0), 0.0, r)
    return vec3(r * torch.cos(phi), r * torch.sin(phi), torch.zeros_like(r))


def sample_hemisphere(u1, u2) -> torch.Tensor:
    """Uniform direction on the +z hemisphere; cos theta = 1 - u2 > 0."""
    return spherical_to_cartesian(TWO_PI * u1, 1.0 - u2)


def sample_hemisphere_cosine(u1, u2) -> torch.Tensor:
    """Cosine-weighted direction on the +z hemisphere: Malley's method,
    the concentric disk projected up."""
    d = sample_unit_disk(u1, u2)
    z = sqrt(torch.clamp_min(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, 0.0))
    return vec3(d[..., 0], d[..., 1], z)


def sample_hemisphere_cosine_pdf(direction: torch.Tensor) -> torch.Tensor:
    return INV_PI * direction[..., 2]


def scatter_dir(prev_dir: torch.Tensor, cos_theta, phi) -> torch.Tensor:
    """Rotate a local (cosθ, φ) scatter direction into the global frame of
    ``prev_dir`` (reference: src/theia/shader/scatter.volume.glsl:7-28).
    The local direction uses the (cos, sin) convention here, unlike
    :func:`spherical_to_cartesian` — matching the reference."""
    prev_dir = normalize(prev_dir)
    sin_theta = sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    local = normalize(
        vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
    )
    vx, vy = local_frame(prev_dir)
    out = local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * prev_dir
    return normalize(out)
