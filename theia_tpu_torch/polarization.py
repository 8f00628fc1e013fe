"""Polarization: Stokes vectors, Mueller matrices and reference-frame
rotations (reference: src/theia/shader/polarization.glsl).

The port of ``theia_tpu.polarization``. Conventions
(docs/pipeline/components.md): the polarization reference frame
``pol_ref`` is a unit vector perpendicular to the propagation direction
pointing along the E_y (vertical) component. Frame rotations act on the
Stokes vector as a 2-phi rotation of (Q, U). Forward rays carry a Stokes
vector; backward rays accumulate a Mueller matrix (4, 4).

All functions are plain tensor code on wavefront tensors: stokes (N, 4),
directions (N, 3), mueller (N, 4, 4).
"""

from __future__ import annotations

import torch

from .lookup import as_table
from .material import Medium
from .ops.math3d import cross, dot, sqrt
from .ops.table_read import PHASE, read_table

__all__ = [
    "rotation_coeffs",
    "apply_rotation",
    "align_pol_ref",
    "rotate_pol_ref",
    "phase_matrix_elements",
    "apply_phase_matrix",
    "polarizer_coeffs",
    "apply_polarizer",
    "rotation_mueller",
    "phase_mueller",
    "polarizer_mueller",
    "unpolarized_stokes",
]


def unpolarized_stokes(shape, device=None) -> torch.Tensor:
    s = torch.zeros((*shape, 4), dtype=torch.float32, device=device)
    s[..., 0] = 1.0
    return s


def rotation_coeffs(ray_dir, old_ref, new_ref):
    """(cos 2phi, sin 2phi) rotating old_ref -> new_ref as seen along
    ray_dir (reference: polarization.glsl:21-34)."""
    cos_phi = dot(old_ref, new_ref)
    sin_phi = dot(cross(old_ref, new_ref), ray_dir)
    c = 2.0 * cos_phi * cos_phi - 1.0
    s = 2.0 * cos_phi * sin_phi
    return c, s


def apply_rotation(stokes, c, s):
    """Rotate (Q, U) by the 2-phi angle given as (cos, sin)."""
    i, q, u, v = stokes.unbind(-1)
    return torch.stack([i, c * q - s * u, s * q + c * u, v], dim=-1)


def align_pol_ref(ray_dir, old_ref, new_ref):
    """Convenience: rotation coefficients for aligning frames."""
    return rotation_coeffs(ray_dir, old_ref, new_ref)


def rotate_pol_ref(direction, ref, new_direction):
    """Rotate the reference frame into the plane of scattering
    direction -> new_direction (reference: polarization.glsl:38-68).

    Returns (new_ref, c, s); degenerate (parallel) case keeps the old
    frame with the identity rotation."""
    new_ref = cross(direction, new_direction)
    length = sqrt(torch.clamp_min(dot(new_ref, new_ref), 1e-30))
    degenerate = length <= 1.0e-7
    safe_ref = new_ref / length[..., None]
    new_ref = torch.where(degenerate[..., None], ref, safe_ref)
    cos_phi = dot(ref, new_ref)
    sin_phi = dot(cross(ref, new_ref), direction)
    c = 2.0 * cos_phi * cos_phi - 1.0
    s = 2.0 * cos_phi * sin_phi
    c = torch.where(degenerate, 1.0, c)
    s = torch.where(degenerate, 0.0, s)
    return new_ref, c, s


def phase_matrix_elements(medium: Medium | None, cos_theta: torch.Tensor):
    """(m12, m22, m33, m34) at the scattering angle
    (reference: polarization.glsl:88-107). A null *medium* yields the
    identity matrix; a medium with null tables yields the depolarizer
    (lookUp null default 0), both as in the reference. The medium's tables
    are tensors on ``cos_theta``'s device (:meth:`Medium.to`)."""
    if medium is None:
        zeros = torch.zeros_like(cos_theta)
        ones = torch.ones_like(cos_theta)
        return zeros, ones, ones, zeros
    tables = tuple(as_table(getattr(medium, f"phase_{m}"), cos_theta.device) for m in ("m12", "m22", "m33", "m34"))
    return read_table(tables, cos_theta, 0.0, affine=PHASE)


def apply_phase_matrix(stokes, m12, m22, m33, m34):
    """Apply the normalized phase matrix
    [[1,m12,0,0],[m12,m22,0,0],[0,0,m33,m34],[0,0,-m34,m33]]."""
    i, q, u, v = stokes.unbind(-1)
    return torch.stack(
        [i + m12 * q, m12 * i + m22 * q, m33 * u + m34 * v, -m34 * u + m33 * v],
        dim=-1,
    )


def polarizer_coeffs(p, s):
    """(att, m12, m33) of the Fresnel polarizer with amplitude coefficients
    (p, s); the matrix itself is normalized — the attenuation
    0.5(p^2+s^2) is applied to lin_contrib separately
    (reference: polarization.glsl:110-121, ray.surface.glsl)."""
    att = p * p + s * s
    safe = torch.where(att > 0, att, 1.0)
    m12 = (p * p - s * s) / safe
    m33 = (2.0 * p * s) / safe
    return att, m12, m33


def apply_polarizer(stokes, m12, m33):
    """Apply [[1,m12,0,0],[m12,1,0,0],[0,0,m33,0],[0,0,0,m33]]."""
    i, q, u, v = stokes.unbind(-1)
    return torch.stack([i + m12 * q, m12 * i + q, m33 * u, m33 * v], dim=-1)


# -- Mueller-matrix forms (for backward rays accumulating (N,4,4)) ----------


def _matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_mueller(c, s):
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _matrix([[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]])


def phase_mueller(m12, m22, m33, m34):
    z, o = torch.zeros_like(m12), torch.ones_like(m12)
    return _matrix(
        [[o, m12, z, z], [m12, m22, z, z], [z, z, m33, m34], [z, z, -m34, m33]]
    )


def polarizer_mueller(m12, m33):
    z, o = torch.zeros_like(m12), torch.ones_like(m12)
    return _matrix(
        [[o, m12, z, z], [m12, o, z, z], [z, z, m33, z], [z, z, z, m33]]
    )
