"""Ray/scene intersection and hit reconstruction.

The nearest-hit selection goes through the scene's tables (the soup
kernels on brute-force packs, the Moeller-Trumbore kernel with
``accel="mt"``, the Woop kernel with ``accel="woop"``, the two-level walk
with ``accel="instanced"``, the threaded-BVH walk with ``accel="bvh"``)
on detached tensors, under ``torch.no_grad()``. On brute-force and
``mt`` packs the query also returns each winner's ``tri_data`` row (the
kernel copies it), unless ``tri_data`` is being differentiated. The winner is then rebuilt from its two table rows
in ordinary torch code — barycentrics, object-space position and normal,
inward test, media-mismatch check, world position via object-to-world —
the only part of intersection that autograd could differentiate, as with
``stop_gradient`` in ``theia_tpu.accel`` (reference:
scene.intersect.glsl:47-99, ray.surface.glsl:22-36).

On brute-force packs :func:`intersect_target` answers the MIS shadow
query with ``theia_tpu``'s split (the nearest hit on the detector
instances, then an any-hit over the other instances bounded by it) in
one launch, ``target_in_table``: the any-hit runs in the same blocks as
the nearest hit, from the winners' t, on the lanes that found one. Both
halves run the one exact test of ``csrc/moller_trumbore.cuh``, so the
winner cannot occlude itself. The port's queries take ``theia_tpu``'s
``chunk=`` keyword and ignore it: the kernels choose their own tiling.
:func:`nearest_culled` and :func:`anyhit_culled` are the queries over
chosen instances (``groups``) and lanes (``active``). ``theia_tpu`` skips
work there by a bounding-sphere test an instance
(:func:`_seg_hits_sphere`) and a fixed-capacity lane compaction with a
full-width fallback, because XLA needs static shapes; its results are
pinned bit-identical to the full scan. The port carries the functions and
their results, not that mechanism: the kernels skip per ray, per chunk
of 256 triangles and per sub-box of 32 (a masked lane enters no chunk's
list, and a chunk's box is tighter than its instance's sphere), so there
is no capacity, no fallback and no knob.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ops.bvh_traverse import nearest_triangle_bvh, occluded_bvh
from .ops.instanced import nearest_triangle_instanced, occluded_instanced
from .ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows
from .ops.intersect_soup import (
    anyhit_in_soup, anyhit_in_table, nearest_in_soup, nearest_in_table, nearest_in_table_rows, target_in_table,
)
from .ops.intersect_woop import nearest_triangle_woop
from .ops.math3d import cross, dot, matvec, moeller_trumbore_rowwise, normalize, sign_bit, sqrt, vec3
from .ops.table_read import gather_rows
from .scene import ScenePack
from .trace.core import EventResultCode

__all__ = [
    "SurfaceHit",
    "anyhit_culled",
    "anyhit_in_soup",
    "intersect_scene",
    "intersect_target",
    "is_visible",
    "nearest_culled",
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


#: whether brute-force and ``mt`` packs take the winners' rows from the
#: query (:func:`nearest_in_table_rows`, :func:`nearest_triangle_mt_rows`)
#: or gather them afterwards (``ops/table_read.gather_rows``); a switch
#: for measuring one against the other, nothing else sets it
ROWS_FROM_QUERY = True


def _seg_hits_sphere(origin, direction, t_max, center, radius) -> torch.Tensor:
    """Conservative: True unless the ray segment [0, t_max] provably
    misses the sphere; ``direction`` need not be unit length. The slack
    covers the float32 rounding of the closest-approach chain (error <=
    ~1e-6 |oc|^2, margin 1e-5 |oc|^2). The rule by which ``theia_tpu``
    culls an instance for a lane; the port's kernels cull by chunk boxes
    instead and do not call it."""
    oc = origin - center
    b = torch.sum(oc * direction, dim=-1)
    d2 = torch.sum(direction * direction, dim=-1)
    tc = torch.minimum(torch.clamp_min(-b / torch.clamp_min(d2, 1e-30), 0.0), t_max)
    p = oc + tc[..., None] * direction
    s = torch.sum(p * p, dim=-1)
    oc2 = torch.sum(oc * oc, dim=-1)
    return s <= radius * radius * 1.003 + oc2 * 1e-5 + 1e-9


def _brute_rays(pack: ScenePack, origin, direction, t_max, what: str):
    """The detached, contiguous rays of a soup query, ``t_max`` (N,)."""
    if pack.soup is None:
        raise ValueError(f"{what} requires a brute-force pack (accel='brute')")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device).detach()
    return (
        origin.detach().contiguous(), direction.detach().contiguous(),
        torch.broadcast_to(t_max, origin.shape[:1]).contiguous(),
    )


def nearest_culled(pack: ScenePack, origin, direction, t_max, chunk=None, *, groups=None, active=None):
    """Nearest hit over the instances ``groups`` of a brute-force pack
    (all by default) on the lanes ``active`` (bool (N,), all by default):
    (t, tri) with ``tri`` the ``tri_data`` row, inf / -1 on a miss and on
    inactive lanes. Bit-identical to the scan over the whole soup where
    ``groups`` is None, as in ``theia_tpu``. ``chunk`` is accepted and
    ignored (the module docstring says why), here and below."""
    rays = _brute_rays(pack, origin, direction, t_max, "nearest_culled")
    return nearest_in_table(pack.soup, *rays, groups=groups, active=active)


def anyhit_culled(pack: ScenePack, origin, direction, t_max, chunk=None, *, groups=None, active=None):
    """Occlusion over the instances ``groups`` of a brute-force pack:
    True where some triangle of them blocks the ray strictly before
    ``t_max``; False on inactive lanes."""
    rays = _brute_rays(pack, origin, direction, t_max, "anyhit_culled")
    return anyhit_in_table(pack.soup, *rays, groups=groups, active=active)


def _nearest(pack: ScenePack, origin, direction, t_max, rows: bool = False):
    """Nearest-hit query via the scene's backend: (t, tri, row) with t =
    inf / tri = -1 on a miss, ``tri`` a row of the pack's ``tri_data`` and
    ``row`` that row (row 0 on a miss) where the query fetched it (with
    ``rows``, on backends that can), else None. The backends share this
    contract (theia_tpu/accel.py:524-558)."""
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    rays = (origin.detach().contiguous(), direction.detach().contiguous(), t_max.detach())
    rows = rows and ROWS_FROM_QUERY
    if pack.instanced is not None:
        with torch.no_grad():
            return (*nearest_triangle_instanced(pack.instanced, *rays), None)
    if pack.bvh is not None:
        with torch.no_grad():
            return (*nearest_triangle_bvh(pack.bvh, *rays), None)
    if pack.woop is not None:
        return (*nearest_triangle_woop(pack.woop, *rays), None)
    if pack.mt is not None:
        if rows:
            return nearest_triangle_mt_rows(pack.mt, pack.tri_data, *rays)
        return (*nearest_triangle_mt(pack.mt, *rays), None)
    if rows:
        return nearest_in_table_rows(pack.soup, pack.tri_data, *rays)
    return (*nearest_in_table(pack.soup, *rays), None)


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
    *,
    chunk=None,
) -> SurfaceHit:
    """Trace the wavefront against the scene and reconstruct full hits.

    ``medium_handle``: i32[N] — the medium each lane believes it is in;
    mismatches against the hit material's expectation raise the
    media-mismatch error exactly like the reference."""
    # the query's rows carry no graph: where tri_data is differentiated,
    # _reconstruct_hit gathers them
    t_sel, tri, row = _nearest(pack, origin, direction, t_max, rows=not pack.tri_data.requires_grad)
    return _reconstruct_hit(pack, medium_handle, origin, direction, t_sel, tri, row)


#: the spans of a ``tri_data`` row that the reconstruction reads: the
#: object-space v0, e1, e2, the vertex normals n0, n1, n2 and the world v0,
#: e1, e2 (3 columns each), then the instance (column 27, an integer)
TRI_COLUMNS = tuple((c, c + 3) for c in range(0, 27, 3)) + ((27, 28, torch.int32),)
#: of an ``inst_data`` row: world_to_obj and obj_to_world (3 x 4 each),
#: then the integers inside and outside medium, the flags of the inward
#: and the outward side, and the detector id (columns 24-28)
INST_COLUMNS = ((0, 12), (12, 24), (24, 29, torch.int32))


def _reconstruct_hit(
    pack: ScenePack, medium_handle, origin, direction, t_sel, tri, row=None
) -> SurfaceHit:
    """Rebuild the full SurfaceHit for per-lane winning triangles ``tri``
    (``tri_data`` rows, -1 on miss); ``row`` is ``tri_data[max(tri, 0)]``
    (N, 32) where the query already fetched it, and its pieces are views
    of it. Otherwise one ``gather_rows`` launch hands over the pieces, as
    one more does those of ``inst_data``: the backward then takes their
    gradients alone, where slices of one (N, 32) gather cost a zero (N,
    32) tensor, a copy and an add of that width a piece."""
    valid = tri >= 0
    if row is None:
        *pieces, inst = gather_rows(pack.tri_data, torch.clamp_min(tri, 0), columns=TRI_COLUMNS)
        inst = inst[:, 0]
    else:
        pieces = [row[:, start:stop] for start, stop in TRI_COLUMNS[:-1]]
        inst = row[:, 27].to(torch.int32)
    o_v0, o_e1, o_e2, n0, n1, n2, wv0, we1, we2 = pieces

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

    w2o, o2w, ints = gather_rows(pack.inst_data, inst, columns=INST_COLUMNS)
    w2o = w2o.reshape(-1, 3, 4)
    o2w = o2w.reshape(-1, 3, 4)
    lin_w2o = w2o[:, :, :3]
    obj_dir = normalize(matvec(lin_w2o, direction))
    inward = dot(obj_dir, obj_nrm) <= 0.0

    inside, outside, flags_in, flags_out, custom_id = ints.unbind(1)
    flags = torch.where(inward, flags_in, flags_out)
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
        custom_id=custom_id,
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
    *,
    chunk=None,
    active: torch.Tensor | None = None,
) -> SurfaceHit:
    """Shadow-ray query: nearest hit *on a detector instance*, invalid if
    any other geometry blocks the ray first.

    MIS shadow rays respond on detector-flagged instances only (the
    reference's volume-mode target+occlusion split,
    scene.traverse.glsl:234-269), so on a brute-force pack the hits are
    ordered over the detector instances alone, and the rest of the scene
    is an any-hit query bounded by the winner's distance (strictly before:
    the winner's own t is not < t). Both halves run in one launch,
    ``target_in_table``, on one exact test, which is what makes the split
    exact; accelerated packs (``mt``, ``woop``, ``bvh``, ``instanced``)
    run the full :func:`intersect_scene`, as ``theia_tpu``'s do (an
    accelerated occlusion query can land an ulp below the bound on the
    winner itself), and so does a pack without a detector.

    ``active``: optional bool[N] — lanes whose result is never consumed
    downstream (e.g. non-miss lanes of the MIS block). Inactive lanes are
    left out of both halves and report ``valid=False``. The any-hit half
    runs only for lanes with a detector hit: no other lane's answer is
    read.
    ``theia_tpu`` takes three routes here (culled groups, the masked
    group scan, the plain subsoup when the scene has no ``CullTables``);
    they give one result, which this is."""
    if pack.soup is None or not any(pack.soup_is_det):
        return intersect_scene(pack, medium_handle, origin, direction, t_max)
    rays = _brute_rays(pack, origin, direction, t_max, "intersect_target")
    # the query's rows carry no graph: where tri_data is differentiated,
    # _reconstruct_hit gathers them
    rows = ROWS_FROM_QUERY and not pack.tri_data.requires_grad
    t_sel, tri, *row = target_in_table(
        pack.soup, *rays, active=active, rows_table=pack.tri_data if rows else None,
        groups=[k for k, d in enumerate(pack.soup_is_det) if d],
        occluders=[k for k, d in enumerate(pack.soup_is_det) if not d],
    )
    return _reconstruct_hit(pack, medium_handle, origin, direction, t_sel, tri, *row)


def is_visible(pack: ScenePack, observer: torch.Tensor, target: torch.Tensor, *, chunk=None) -> torch.Tensor:
    """True where observer and target see each other
    (reference: scene.intersect.glsl:104-124)."""
    d = (target - observer).detach()
    dist = sqrt(torch.clamp_min(dot(d, d), 1e-30))
    direction = d / dist[:, None]
    observer = observer.detach().contiguous()
    if pack.instanced is not None:
        # occlusion needs no ordering: a lane stops at its first blocking candidate
        return ~occluded_instanced(pack.instanced, observer, direction, dist)
    if pack.bvh is not None:
        return ~occluded_bvh(pack.bvh, observer, direction, dist)
    if pack.soup is not None:
        return ~anyhit_culled(pack, observer, direction, dist)
    return _nearest(pack, observer, direction, dist)[1] < 0
