"""3D vector math on tensors with a trailing component axis.

Vectors are ``f32[..., 3]``; functions broadcast over leading axes.
Semantics follow ``theia_tpu.ops.math3d`` (reference:
src/theia/shader/math.glsl:17-94). Sums over the three components are
written out left to right, so they round in the same order on every
device.
"""

from __future__ import annotations

import torch

__all__ = [
    "sqrt",
    "vec3",
    "dot",
    "cross",
    "norm",
    "normalize",
    "distance",
    "sign_bit",
    "local_frame",
    "perpendicular_to",
    "perpendicular_to2",
    "intersect_sphere",
    "matvec",
    "moeller_trumbore_rowwise",
]


def _sqrt_value(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and x.device.type == "cpu":
        # torch's CPU float32 sqrt is not correctly rounded (1 ulp off on
        # some inputs); through float64 it is: rounding a correctly rounded
        # 53-bit sqrt to 24 bits gives the correctly rounded 24-bit one
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


#: JAX's sqrt JVP divides this by the root; a 0-d CPU tensor, so that the
#: division is one kernel on any device (``0.5 / ans`` would take a
#: reciprocal and a product)
_HALF = torch.tensor(0.5)


class _Sqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ans = _sqrt_value(x)
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * torch.div(_HALF.to(ans.dtype), ans)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as XLA's: on CPU float32 tensors
    through float64, on the card ``torch.sqrt`` (CUDA's IEEE sqrt). Its
    gradient is JAX's, ``g * (0.5 / sqrt(x))`` in the input's type. Every
    square root of the port's lanes goes through here, never
    ``torch.sqrt``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sqrt.apply(x)
    return _sqrt_value(x)


def vec3(x, y, z) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return vec3(
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    )


def norm(a: torch.Tensor) -> torch.Tensor:
    # the eps floor keeps norm/normalize finite on zero vectors (masked
    # dead lanes); 1e-30 is a normal float32
    return sqrt(torch.clamp_min(dot(a, a), 1e-30))


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / norm(a)[..., None]


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return norm(a - b)


def sign_bit(f: torch.Tensor) -> torch.Tensor:
    """+-1.0 from the sign bit; maps +-0.0 to +-1.0 (unlike ``torch.sign``)."""
    bits = (f.contiguous().view(torch.int32) & -0x80000000) | 0x3F800000
    return bits.view(torch.float32)


def local_frame(vz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis completion (Duff et al. / PBRT 3.3.3).

    Returns (vx, vy) such that (vx, vy, vz) is a right-handed orthonormal
    frame; matches the reference's ``createLocalCOSY``."""
    z = vz[..., 2]
    s = sign_bit(z)
    a = -1.0 / (s + z)
    b = vz[..., 0] * vz[..., 1] * a
    vx = vec3(1.0 + s * vz[..., 0] * vz[..., 0] * a, s * b, -s * vz[..., 0])
    vy = vec3(b, s + vz[..., 1] * vz[..., 1] * a, -vz[..., 1])
    return normalize(vx), normalize(vy)


def perpendicular_to(v: torch.Tensor) -> torch.Tensor:
    """A unit vector normal to unit vector v (the frame's vy)."""
    s = sign_bit(v[..., 2])
    a = -1.0 / (s + v[..., 2])
    b = v[..., 0] * v[..., 1] * a
    return vec3(b, s + v[..., 1] * v[..., 1] * a, -v[..., 1])


def perpendicular_to2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unit vector normal to both a and b; falls back to a vector
    perpendicular to a when they are (nearly) parallel."""
    c = cross(a, b)
    length = norm(c)
    degenerate = length < 1e-5
    safe = c / torch.clamp_min(length, 1e-20)[..., None]
    return torch.where(degenerate[..., None], perpendicular_to(a), safe)


def intersect_sphere(center, radius, origin: torch.Tensor, direction: torch.Tensor):
    """Robust ray/sphere intersection ("Ray Tracing Gems" ch. 7), in the
    op order of ``theia_tpu.ops.math3d.intersect_sphere``.

    Returns (t_near, t_far), both +inf on miss; t_near <= t_far."""
    f = origin - center
    b2 = dot(f, direction)
    r2 = radius * radius
    fd = f - b2[..., None] * direction
    discr = r2 - dot(fd, fd)
    c = dot(f, f) - r2
    q = -b2 - sign_bit(b2) * sqrt(torch.clamp_min(discr, 0.0))
    t1 = c / q
    t_near = torch.minimum(t1, q)
    t_far = torch.maximum(t1, q)
    miss = discr < 0.0
    return torch.where(miss, torch.inf, t_near), torch.where(miss, torch.inf, t_far)


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise ``m @ v`` for (N, 3, >=3) matrices and (N, 3) vectors."""
    return vec3(*(dot(m[:, i, :3], v) for i in range(3)))


def moeller_trumbore_rowwise(origin, direction, v0, e1, e2):
    """Row-wise Moeller-Trumbore: one (N,)-lane ray against one (N,)-lane
    triangle (v0, e1, e2). Returns (b1, b2, t, inv) with ``inv = 0`` for
    degenerate (|det| <= 1e-12) pairs."""
    px = direction[:, 1] * e2[:, 2] - direction[:, 2] * e2[:, 1]
    py = direction[:, 2] * e2[:, 0] - direction[:, 0] * e2[:, 2]
    pz = direction[:, 0] * e2[:, 1] - direction[:, 1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tx = origin[:, 0] - v0[:, 0]
    ty = origin[:, 1] - v0[:, 1]
    tz = origin[:, 2] - v0[:, 2]
    b1 = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    b2 = (direction[:, 0] * qx + direction[:, 1] * qy + direction[:, 2] * qz) * inv
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
    return b1, b2, t, inv
