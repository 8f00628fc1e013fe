"""Ray/scene intersection and hit reconstruction.

The nearest-hit selection goes through the scene's acceleration tables
(so far the Moeller-Trumbore kernel, ``accel="mt"``, or the Woop kernel,
``accel="woop"``) on detached tensors. On ``mt`` packs the query also
returns each winner's ``tri_data`` row (the kernel copies it), unless
``tri_data`` is being differentiated. The winner is then rebuilt from
its two table rows in ordinary torch code — barycentrics, object-space position and normal, inward
test, media-mismatch check, world position via object-to-world — the
only part of intersection that autograd could differentiate, as with
``stop_gradient`` in ``theia_tpu.accel`` (reference:
scene.intersect.glsl:47-99, ray.surface.glsl:22-36).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows
from .ops.intersect_woop import nearest_triangle_woop
from .ops.math3d import cross, dot, matvec, moeller_trumbore_rowwise, normalize, sign_bit, vec3
from .scene import ScenePack
from .trace.core import EventResultCode

__all__ = [
    "SurfaceHit",
    "intersect_scene",
    "intersect_target",
    "offset_ray",
]


@dataclass(frozen=True)
class SurfaceHit:
    """Wavefront surface-hit description
    (reference: src/theia/shader/scene.types.glsl:31-57)."""

    valid: torch.Tensor  # bool[N]
    t: torch.Tensor  # f32[N] ray parameter (inf on miss)
    instance: torch.Tensor  # i32[N]
    custom_id: torch.Tensor  # i32[N] detectorId
    flags: torch.Tensor  # i32[N] material flags for the hit side
    inward: torch.Tensor  # bool[N]
    medium_in: torch.Tensor  # i32[N] medium handle on the incident side
    medium_tr: torch.Tensor  # i32[N] medium handle on the transmitted side
    world_pos: torch.Tensor  # f32[N,3]
    ray_nrm: torch.Tensor  # f32[N,3] normal opposing the ray
    obj_pos: torch.Tensor  # f32[N,3]
    obj_nrm: torch.Tensor  # f32[N,3] outward geometric normal (object space)
    obj_dir: torch.Tensor  # f32[N,3]
    world_to_obj: torch.Tensor  # f32[N,3,3]
    error: torch.Tensor  # i32[N] media-mismatch error code or 0


#: whether ``mt`` packs take the winners' rows from the query
#: (:func:`nearest_triangle_mt_rows`) or gather them in torch; a switch
#: for measuring one against the other, nothing else sets it
MT_ROWS_FROM_QUERY = True


def offset_ray(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Self-intersection-safe offset of position ``p`` along normal ``n``
    ("Ray Tracing Gems" ch. 6; reference: ray.surface.glsl:22-36)."""
    of_i = (256.0 * n).to(torch.int32)  # truncates toward zero
    p_i_bits = p.contiguous().view(torch.int32) + torch.where(p < 0.0, -of_i, of_i)
    p_i = p_i_bits.view(torch.float32)
    return torch.where(torch.abs(p) < (1.0 / 32.0), p + (1.0 / 65536.0) * n, p_i)


def intersect_scene(
    pack: ScenePack,
    medium_handle: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max,
) -> SurfaceHit:
    """Trace the wavefront against the scene and reconstruct full hits.

    ``medium_handle``: i32[N] — the medium each lane believes it is in;
    mismatches against the hit material's expectation raise the
    media-mismatch error exactly like the reference."""
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    # (t, tri_data row) per lane, t=inf / row=-1 on miss; the Pallas-ported
    # backends share this contract (theia_tpu/accel.py:537-544)
    rays = (origin.detach().contiguous(), direction.detach().contiguous(), t_max.detach())
    row = None
    if pack.mt is None:
        t_sel, tri = nearest_triangle_woop(pack.woop, *rays)
    elif MT_ROWS_FROM_QUERY and not pack.tri_data.requires_grad:
        t_sel, tri, row = nearest_triangle_mt_rows(pack.mt, pack.tri_data, *rays)
    else:  # the query's rows carry no graph
        t_sel, tri = nearest_triangle_mt(pack.mt, *rays)
    return _reconstruct_hit(pack, medium_handle, origin, direction, t_sel, tri, row)


def _reconstruct_hit(
    pack: ScenePack, medium_handle, origin, direction, t_sel, tri, row=None
) -> SurfaceHit:
    """Rebuild the full SurfaceHit for per-lane winning triangles ``tri``
    (``tri_data`` rows, -1 on miss); ``row`` is ``tri_data[max(tri, 0)]``
    (N, 32) where the query already fetched it."""
    valid = tri >= 0
    if row is None:
        row = pack.tri_data[torch.clamp_min(tri, 0)]  # (N, 32)
    o_v0, o_e1, o_e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    wv0, we1, we2 = row[:, 18:21], row[:, 21:24], row[:, 24:27]
    inst = row[:, 27].to(torch.int32)

    # winner barycentrics (Moeller-Trumbore on the world triangle)
    b1, b2, t_win, inv = moeller_trumbore_rowwise(origin, direction, wv0, we1, we2)
    # differentiable winner t; the backend's own t where the world-space
    # det underflows the degeneracy cutoff
    t = torch.where(valid, torch.where(inv != 0.0, t_win, t_sel), torch.inf)

    bb1, bb2 = b1[:, None], b2[:, None]
    obj_pos = o_v0 + bb1 * o_e1 + bb2 * o_e2
    obj_nrm = cross(o_e1, o_e2)
    int_nrm = n0 + bb1 * (n1 - n0) + bb2 * (n2 - n0)
    # match sign of the geometric normal to the authored vertex normals
    obj_nrm = normalize(obj_nrm * sign_bit(dot(obj_nrm, int_nrm))[:, None])

    irow = pack.inst_data[inst]  # (N, 32)
    w2o = irow[:, 0:12].reshape(-1, 3, 4)
    o2w = irow[:, 12:24].reshape(-1, 3, 4)
    lin_w2o = w2o[:, :, :3]
    obj_dir = normalize(matvec(lin_w2o, direction))
    inward = dot(obj_dir, obj_nrm) <= 0.0

    flags = torch.where(inward, irow[:, 26], irow[:, 27]).to(torch.int32)
    inside = irow[:, 24].to(torch.int32)
    outside = irow[:, 25].to(torch.int32)
    medium_expected = torch.where(inward, outside, inside)
    medium_tr = torch.where(inward, inside, outside)
    mismatch = valid & (medium_handle != medium_expected)
    error = torch.where(
        mismatch, int(EventResultCode.ERROR_MEDIA_MISMATCH), 0
    ).to(torch.int32)

    # world normal: n_w = n_o @ W2O_linear (covariant transform)
    world_nrm = normalize(
        vec3(*(dot(obj_nrm, lin_w2o[:, :, j]) for j in range(3)))
    )
    ray_nrm = world_nrm * torch.where(inward, 1.0, -1.0)[:, None]
    # world pos via object-to-world (reference: scene.intersect.glsl:90-95)
    world_pos = matvec(o2w, obj_pos) + o2w[:, :, 3]

    return SurfaceHit(
        valid=valid,
        t=t,
        instance=inst,
        custom_id=irow[:, 28].to(torch.int32),
        flags=flags,
        inward=inward,
        medium_in=medium_handle,
        medium_tr=medium_tr,
        world_pos=world_pos,
        ray_nrm=ray_nrm,
        obj_pos=obj_pos,
        obj_nrm=obj_nrm,
        obj_dir=obj_dir,
        world_to_obj=lin_w2o,
        error=error,
    )


def intersect_target(
    pack: ScenePack,
    medium_handle: torch.Tensor,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max,
) -> SurfaceHit:
    """Shadow-ray query: nearest hit, whose detector flag the caller tests.

    ``theia_tpu`` splits this into a detector nearest-hit plus an
    occluder any-hit on brute-force packs only; accelerated packs (``mt``
    and ``woop``), the only kinds ported so far, run the full
    :func:`intersect_scene`."""
    return intersect_scene(pack, medium_handle, origin, direction, t_max)
