"""Nearest-hit, any-hit and shadow-pair queries over the brute-force
triangle soup.

The counterpart of the soup functions of ``theia_tpu/accel.py``
(``nearest_in_soup`` l.73, ``anyhit_in_soup`` l.188, with
``nearest_culled``'s and ``anyhit_culled``'s groups and masks, l.372 and
l.468, and the split of ``intersect_target``, l.688), which ``theia_tpu``
writes in jnp and leaves to XLA to fuse. They hold kernels here
(``csrc/intersect_soup.cu``), so they live beside the other kernel
wrappers.

A brute-force scene keeps its triangles in instance order, and its
queries ask for some instances only: the MIS shadow ray wants the nearest
hit on the detectors and any hit on everything else. :class:`SoupTable`
is the kernels' table for that: the rows of :func:`~.intersect_mt.mt_aos`
with every group (instance) in Morton order and starting on a boundary of
:data:`~.intersect_mt.CHUNK` rows, each row carrying its soup index, the
boxes of every chunk and of every :data:`~.intersect_mt.SUB` rows in it,
and per chunk how many of its rows are real. A hit's index is the
triangle's row in the soup it came from (the scene's ``tri_data`` row),
whatever the order and the padding; ties go to the lowest row. The
Morton order within each group made a flagship batch's detector queries
need 16 % fewer pairs than the soup's own order, its primary queries 9 %.
The MT pack's queries (``intersect_mt``) are the same kernels over a
table of one group.

:func:`nearest_in_table`, :func:`nearest_in_table_rows`,
:func:`anyhit_in_table` and :func:`target_in_table` launch the kernels on
CUDA tensors and run the plain versions (:func:`~.intersect_mt.chunk_walk`
over the same exact test, ``_mt_exact_plain``, with the table's sub-boxes)
on CPU tensors; kernel and plain version agree bit for bit. ``groups``
names the groups to scan, ``active`` (bool (N,)) the lanes that need an
answer: a lane that is out reports a miss (inf, -1, row 0; False), and
costs the kernel nothing. :func:`target_in_table` is the shadow pair in
one launch: the nearest hit over the detector groups, then the any-hit
over the occluder groups bounded by it, in the same blocks.
:func:`nearest_in_soup` and :func:`anyhit_in_soup` keep the JAX signatures
on raw (T, 3) arrays, ``chunk`` included (ignored: the kernels choose
their own tiling).

What bounds the kernels on an H100 and what their design does about it
(sub-boxes, the sphere test from where a ray enters a sub-box, masked
lanes that cost nothing, the two halves in one launch) is in the header
of ``csrc/nearest_scan.cuh``; ``intersect_mt._mt_sphere_miss_plain`` and
``_mt_reject_plain`` are the plain twins of its two rejection tests,
which never drop a pair that the exact test accepts.

Against ``theia_tpu`` the results agree to rounding, not bit for bit:
JAX divides by det where the port's exact test takes a correctly rounded
reciprocal and one Newton step.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .intersect_mt import (
    CHUNK, INDEX_COLUMN, ROW_AOS, ROW_WIDTH, SUB, _mt_exact_plain, check_rays, chunk_boxes, chunk_walk, morton_order,
    mt_aos,
)

__all__ = [
    "SoupTable",
    "nearest_in_table",
    "nearest_in_table_plain",
    "nearest_in_table_rows",
    "nearest_in_table_rows_plain",
    "anyhit_in_table",
    "anyhit_in_table_plain",
    "nearest_in_soup",
    "nearest_in_soup_plain",
    "anyhit_in_soup",
    "anyhit_in_soup_plain",
    "target_in_table",
    "target_in_table_plain",
    "group_order",
]


class SoupTable:
    """The kernels' tables over a soup ``v0``, ``e1``, ``e2`` (f32 (T, 3)
    on one device) cut into ``spans``: ``(start, end)`` rows of each group,
    in ascending order; one group of everything by default.

    Within each group the triangles go in ``order``: by default the Morton
    order of their centroids in the group's own box (:func:`group_order`),
    so that a chunk of :data:`~.intersect_mt.CHUNK` rows holds triangles
    that lie close together and its box is tight. ``order`` (int (T,), a
    permutation that keeps every row inside its group) may also be given,
    e.g. ``numpy.arange(T)`` for the soup's own order or the order of the
    table a rigidly moved instance came from. ``rows`` (9, P) and ``aos``
    (P, ROW_AOS) hold the triangles so ordered with each group padded to
    whole chunks by copies of its last triangle (finite values, never
    visited: ``chunk_count`` says how many rows of a chunk are real);
    ``index`` (i32 (P,)) is the soup row of each table row, which is also
    kept in column 11 of ``aos`` as int32 bits, where the kernels read it;
    ``chunk_box`` (P / CHUNK, 8) are the
    chunks' skip boxes and ``sub_box`` (P / SUB, 8) those of every run of
    :data:`~.intersect_mt.SUB` rows, a warp's share of a chunk in the
    kernels; ``chunk_first`` is the soup row at which the
    chunk's run of its group starts (in the soup's own order, the index
    of its first triangle). ``n_tri`` is T, ``soup`` the three arrays as
    they were given."""

    def __init__(self, v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor, spans=None, order=None) -> None:
        self.n_tri = v0.shape[0]
        self.soup = (v0, e1, e2)
        self.spans = ((0, self.n_tri),) if spans is None else tuple((int(s), int(e)) for s, e in spans)
        if order is None:
            order = group_order(*(a.detach().cpu().numpy() for a in self.soup), self.spans)
        self.order = np.asarray(order, np.int64)
        source, first, count, self.group_chunks = [], [], [], []
        for start, end in self.spans:
            n_chunks = -(-(end - start) // CHUNK)
            self.group_chunks.append((len(first), len(first) + n_chunks))
            rows = self.order[start:end]
            if sorted(rows.tolist()) != list(range(start, end)):
                raise ValueError(f"order must keep the rows of group {(start, end)} inside it")
            source.append(rows[np.minimum(np.arange(n_chunks * CHUNK), end - start - 1)])
            first += [start + CHUNK * k for k in range(n_chunks)]
            count += [min(CHUNK, end - start - CHUNK * k) for k in range(n_chunks)]
        self.n_chunks = len(first)
        device = v0.device
        self._visits = list(zip(range(self.n_chunks), first, count))
        self.chunk_first = torch.as_tensor(first, dtype=torch.int32, device=device)
        self.chunk_count = torch.as_tensor(count, dtype=torch.int32, device=device)
        if self.n_chunks:
            src = torch.as_tensor(np.concatenate(source), device=device)
            v0, e1, e2 = v0[src], e1[src], e2[src]
            self.index = src.to(torch.int32)
            self.rows = torch.cat([v0, e1, e2], dim=1).T.contiguous()
            self.aos = mt_aos(self.rows)
            self.aos.view(torch.int32)[:, INDEX_COLUMN] = self.index
            self.chunk_box = chunk_boxes(v0, e1, e2)
            self.sub_box = chunk_boxes(v0, e1, e2, SUB)
        else:
            self.index = torch.zeros(0, dtype=torch.int32, device=device)
            self.rows = torch.zeros((9, 0), dtype=torch.float32, device=device)
            self.aos = torch.zeros((0, ROW_AOS), dtype=torch.float32, device=device)
            self.chunk_box = torch.zeros((0, 8), dtype=torch.float32, device=device)
            self.sub_box = torch.zeros((0, 8), dtype=torch.float32, device=device)
        self._chunk_lists: dict = {}

    def _group_ids(self, groups):
        ids = range(len(self.spans)) if groups is None else groups
        return tuple(sorted({int(k) for k in ids}))

    def visits(self, groups=None) -> list:
        """``(chunk, first, count)`` of the chunks of ``groups`` (all of
        them by default), as :func:`~.intersect_mt.chunk_walk` takes them."""
        return [v for k in self._group_ids(groups) for v in self._visits[slice(*self.group_chunks[k])]]

    def chunk_list(self, groups=None) -> torch.Tensor:
        """i32 ids of the chunks of ``groups`` on the table's device, as
        the kernels take them; made once for each set of groups."""
        key = self._group_ids(groups)
        if key not in self._chunk_lists:
            ids = [c for k in key for c in range(*self.group_chunks[k])]
            self._chunk_lists[key] = torch.as_tensor(ids, dtype=torch.int32, device=self.aos.device)
        return self._chunk_lists[key]

    def to(self, device) -> "SoupTable":
        """A table on ``device``, derived there from a copy of the soup, in
        the same order."""
        return SoupTable(*(a.to(device) for a in self.soup), self.spans, self.order)


def group_order(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, spans) -> np.ndarray:
    """The rows of each group of a soup (numpy (T, 3) x3) sorted along a 3D
    Morton curve of their centroids, in float64 in the group's own box, so
    that the order follows the shape of the group and not its place. A
    rigid move of a group may still change the rounding of a centroid's
    cell; ``ScenePack.translate_instance`` keeps the order of the table
    it came from."""
    v0, e1, e2 = (np.asarray(a, np.float64) for a in (v0, e1, e2))
    order = np.arange(v0.shape[0], dtype=np.int64)
    for s, e in spans:
        if e > s:
            order[s:e] = s + morton_order(v0[s:e], e1[s:e], e2[s:e])
    return order


def _check(table: SoupTable, origin, direction, t_max, active, extra=()):
    t_max = check_rays(
        origin, direction, t_max,
        (
            ("table.aos", table.aos, (table.n_chunks * CHUNK, ROW_AOS)),
            ("table.chunk_box", table.chunk_box, (table.n_chunks, 8)),
            ("table.sub_box", table.sub_box, (table.n_chunks * CHUNK // SUB, 8)),
            *extra,
        ),
    )
    if active is not None and (
        active.dtype != torch.bool or active.shape != t_max.shape
        or active.device != origin.device or not active.is_contiguous()
    ):
        raise ValueError(f"active must be a contiguous bool tensor of shape {tuple(t_max.shape)} on {origin.device}")
    return t_max


def _pair_test(table: SoupTable):
    return lambda o, d, c0: _mt_exact_plain(table.rows[:, c0 : c0 + CHUNK], o, d)


def _walk(table: SoupTable, origin, direction, t_max, groups, active, stats, any_hit=False):
    """The plain walk over the chunks of ``groups`` with the table's
    sub-boxes and row indices, as the kernels visit them."""
    return chunk_walk(
        table.n_tri, table.chunk_box, origin, direction, t_max, _pair_test(table), stats,
        visits=table.visits(groups), active=active, any_hit=any_hit, index=table.index, sub_box=table.sub_box,
    )


def _ptr(a) -> int | None:
    return None if a is None else a.data_ptr()


def _launch(fn, name, table, origin, direction, t_max, active, *lists_and_outputs) -> None:
    """Launch a soup kernel; its arguments after the rays and the tables
    are ``lists_and_outputs``: the chunk lists as (pointer, length), the
    ray count and the outputs."""
    err = fn(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), _ptr(active),
        table.aos.data_ptr(), table.chunk_box.data_ptr(), table.sub_box.data_ptr(), table.chunk_count.data_ptr(),
        *lists_and_outputs, _build.stream_handle(origin.device),
    )
    _build.check(err, name)


def _all_miss(origin):
    n = origin.shape[0]
    return (
        torch.full((n,), torch.inf, dtype=torch.float32, device=origin.device),
        torch.full((n,), -1, dtype=torch.int32, device=origin.device),
    )


def nearest_in_table_plain(table: SoupTable, origin, direction, t_max, *, groups=None, active=None, stats=None):
    """Plain PyTorch version of :func:`nearest_in_table` (any device)."""
    return _walk(table, origin, direction, t_max, groups, active, stats)


def nearest_in_table(table: SoupTable, origin, direction, t_max, *, groups=None, active=None):
    """Nearest hit over the groups ``groups`` of ``table``: (t, idx) with
    idx the triangle's row of the soup, t = inf / idx = -1 on a miss and on
    lanes that ``active`` takes out. ``origin``/``direction``: f32 (N, 3),
    the direction need not be unit length; ``t_max``: a scalar or f32 (N,),
    a hit counts only strictly before it; the lowest row wins ties. CUDA
    tensors launch ``theia_soup_nearest``, CPU tensors run the plain
    version."""
    n = origin.shape[0]
    t_max = _check(table, origin, direction, t_max, active)
    if origin.device.type == "cpu":
        return nearest_in_table_plain(table, origin, direction, t_max, groups=groups, active=active)
    chunks = table.chunk_list(groups)
    if n == 0 or chunks.numel() == 0:  # nothing to scan: every lane misses, no launch
        return _all_miss(origin)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    _launch(
        _build.library().theia_soup_nearest, "nearest_in_table", table, origin, direction, t_max, active,
        chunks.data_ptr(), chunks.numel(), n, t.data_ptr(), idx.data_ptr(),
    )
    nearest_in_table.launches += 1
    return t, idx


nearest_in_table.launches = 0


def _gather_rows(rows_table, idx):
    return rows_table[torch.clamp_min(idx, 0).to(torch.int64)]


def nearest_in_table_rows_plain(
    table: SoupTable, rows_table, origin, direction, t_max, *, groups=None, active=None, stats=None
):
    """Plain PyTorch version of :func:`nearest_in_table_rows`: the plain
    query, then a gather of ``rows_table[max(idx, 0)]``."""
    t, idx = nearest_in_table_plain(table, origin, direction, t_max, groups=groups, active=active, stats=stats)
    return t, idx, _gather_rows(rows_table, idx)


def _check_rows_table(table: SoupTable, rows_table):
    if rows_table.shape[0] < max(table.n_tri, 1):
        raise ValueError(f"rows_table has {rows_table.shape[0]} rows, fewer than {table.n_tri} triangles")
    return (("rows_table", rows_table, (rows_table.shape[0], ROW_WIDTH)),)


def nearest_in_table_rows(table: SoupTable, rows_table, origin, direction, t_max, *, groups=None, active=None):
    """:func:`nearest_in_table` plus each winner's row of ``rows_table``
    (f32 (R >= table.n_tri, 32), e.g. the scene's ``tri_data``): (t, idx,
    rows) with rows (N, 32) = ``rows_table[max(idx, 0)]``. CUDA tensors
    launch ``theia_soup_nearest_rows``, which copies the rows itself."""
    n = origin.shape[0]
    t_max = _check(table, origin, direction, t_max, active, _check_rows_table(table, rows_table))
    if origin.device.type == "cpu":
        return nearest_in_table_rows_plain(table, rows_table, origin, direction, t_max, groups=groups, active=active)
    chunks = table.chunk_list(groups)
    if n == 0 or chunks.numel() == 0:
        return (*_all_miss(origin), rows_table[:1].expand(n, ROW_WIDTH).contiguous())
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    rows = torch.empty((n, ROW_WIDTH), dtype=torch.float32, device=origin.device)
    _launch(
        _build.library().theia_soup_nearest_rows, "nearest_in_table_rows", table, origin, direction, t_max, active,
        chunks.data_ptr(), chunks.numel(), n, rows_table.data_ptr(), t.data_ptr(), idx.data_ptr(), rows.data_ptr(),
    )
    nearest_in_table_rows.launches += 1
    return t, idx, rows


nearest_in_table_rows.launches = 0


def anyhit_in_table_plain(table: SoupTable, origin, direction, t_max, *, groups=None, active=None, stats=None):
    """Plain PyTorch version of :func:`anyhit_in_table` (any device)."""
    return _walk(table, origin, direction, t_max, groups, active, stats, any_hit=True)


def anyhit_in_table(table: SoupTable, origin, direction, t_max, *, groups=None, active=None):
    """Occlusion over the groups ``groups`` of ``table``: bool (N,), True
    where some triangle is hit at 0 < t < ``t_max`` (a scalar or f32 (N,)),
    strictly; False on lanes that ``active`` takes out and where there is
    no triangle to test. CUDA tensors launch ``theia_soup_anyhit``, in
    which a ray leaves the scan at its first hit; CPU tensors run the
    plain version."""
    n = origin.shape[0]
    t_max = _check(table, origin, direction, t_max, active)
    if origin.device.type == "cpu":
        return anyhit_in_table_plain(table, origin, direction, t_max, groups=groups, active=active)
    chunks = table.chunk_list(groups)
    if n == 0 or chunks.numel() == 0:  # e.g. a scene whose every triangle is a detector
        return torch.zeros(n, dtype=torch.bool, device=origin.device)
    occluded = torch.empty(n, dtype=torch.bool, device=origin.device)
    _launch(
        _build.library().theia_soup_anyhit, "anyhit_in_table", table, origin, direction, t_max, active,
        chunks.data_ptr(), chunks.numel(), n, occluded.data_ptr(),
    )
    anyhit_in_table.launches += 1
    return occluded


anyhit_in_table.launches = 0


def target_in_table_plain(
    table: SoupTable, origin, direction, t_max, *, groups, occluders, active=None, rows_table=None, stats=None
):
    """Plain PyTorch version of :func:`target_in_table`: the composition
    it replaces, the nearest hit over ``groups``, then the any-hit over
    ``occluders`` bounded by its t on the lanes that found one, then the
    masks. ``stats`` counts the pairs of both walks."""
    t, idx = nearest_in_table_plain(table, origin, direction, t_max, groups=groups, active=active, stats=stats)
    found = idx >= 0
    occluded = anyhit_in_table_plain(table, origin, direction, t, groups=occluders, active=found, stats=stats)
    valid = found & ~occluded
    t, idx = torch.where(valid, t, torch.inf), torch.where(valid, idx, -1)
    if rows_table is None:
        return t, idx
    return t, idx, _gather_rows(rows_table, idx)


def target_in_table(table: SoupTable, origin, direction, t_max, *, groups, occluders, active=None, rows_table=None):
    """The MIS shadow query over ``table`` in one pass: the nearest hit
    over the groups ``groups`` (the detectors) strictly before ``t_max``
    on the lanes of ``active``, then, for the lanes that found one,
    whether a triangle of the groups ``occluders`` is hit strictly before
    it. Returns (t, idx) of the nearest hit, inf / -1 where there is none
    or it is occluded, and with ``rows_table`` (as
    :func:`nearest_in_table_rows` takes it) also each lane's row of it
    (row 0 there). Both halves run the one exact test, so a winner cannot
    occlude itself. CUDA tensors launch ``theia_soup_target`` (one launch:
    the any-hit runs in the same blocks, from keys that start at the
    winners' t), CPU tensors run the plain version."""
    n = origin.shape[0]
    extra = () if rows_table is None else _check_rows_table(table, rows_table)
    t_max = _check(table, origin, direction, t_max, active, extra)
    if origin.device.type == "cpu":
        return target_in_table_plain(
            table, origin, direction, t_max, groups=groups, occluders=occluders, active=active, rows_table=rows_table
        )
    det, occ = table.chunk_list(groups), table.chunk_list(occluders)
    if n == 0 or det.numel() == 0:
        miss = _all_miss(origin)
        return miss if rows_table is None else (*miss, rows_table[:1].expand(n, ROW_WIDTH).contiguous())
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    rows = None if rows_table is None else torch.empty((n, ROW_WIDTH), dtype=torch.float32, device=origin.device)
    _launch(
        _build.library().theia_soup_target, "target_in_table", table, origin, direction, t_max, active,
        det.data_ptr(), det.numel(), occ.data_ptr(), occ.numel(), n, _ptr(rows_table),
        t.data_ptr(), idx.data_ptr(), _ptr(rows),
    )
    target_in_table.launches += 1
    return (t, idx) if rows is None else (t, idx, rows)


target_in_table.launches = 0


def nearest_in_soup(v0, e1, e2, origin, direction, t_max, chunk=None):
    """``theia_tpu.accel.nearest_in_soup`` on raw (T, 3) arrays: (t,
    tri_idx), tri_idx == -1 and t == inf on a miss. Builds the table on
    every call; a scene keeps one (``ScenePack.soup``). ``chunk``, the
    JAX function's scan tile, is accepted and ignored: the kernels choose
    their own tiling."""
    return nearest_in_table(SoupTable(v0, e1, e2), origin, direction, t_max)


def nearest_in_soup_plain(v0, e1, e2, origin, direction, t_max, chunk=None):
    """Plain PyTorch version of :func:`nearest_in_soup`."""
    return nearest_in_table_plain(SoupTable(v0, e1, e2), origin, direction, _broadcast(t_max, origin))


def anyhit_in_soup(v0, e1, e2, origin, direction, t_max, chunk=None):
    """``theia_tpu.accel.anyhit_in_soup`` on raw (T, 3) arrays: True where
    some triangle blocks the ray strictly before ``t_max``; all False on
    an empty soup. ``chunk`` is accepted and ignored, as by
    :func:`nearest_in_soup`."""
    return anyhit_in_table(SoupTable(v0, e1, e2), origin, direction, t_max)


def anyhit_in_soup_plain(v0, e1, e2, origin, direction, t_max, chunk=None):
    """Plain PyTorch version of :func:`anyhit_in_soup`."""
    return anyhit_in_table_plain(SoupTable(v0, e1, e2), origin, direction, _broadcast(t_max, origin))


def _broadcast(t_max, origin) -> torch.Tensor:
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    return torch.broadcast_to(t_max, origin.shape[:1]).contiguous()
