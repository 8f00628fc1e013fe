"""Tile helpers of the nearest-hit queries, and the wavefront sort.

The port of ``theia_tpu/ops/_intersect_tiles.py``'s host half: the
per-tile AABBs of the packs (:func:`tile_aabbs`), the sign-keeping clamp
of the slab tests' reciprocals (:func:`safe`) and the wavefront sort that
the MT and Woop queries run when asked (:func:`run_binned`): the rays
sorted by :func:`octant_cell_key`, the query run on the sorted rays, its
outputs scattered back to lane order. Each lane's result is its own, so a
binned query is bit-equal to an unbinned one; only which rays share a
block of the scan changes. ``theia_tpu`` sorts by default from
:data:`BIN_THRESHOLD` triangles on, where its tiles' AABB skip gains from
coherent blocks; the port's scans cull each ray on its own, the sort
measured slower there on the card, so its queries sort only when a
caller passes ``binned=True`` (``Scene(binned=True)`` for a tracer). The
Pallas-body helpers of the JAX module (``rcp``, ``block_slab_hit``,
``select_winner``, ``pack_rays``, ``check_vmem_budget``) have no
counterpart: the port's scans are CUDA kernels that need no ray padding
and no VMEM budget.

On CUDA tensors the sort and the scatter back are the hand-written
kernels of ``csrc/wavefront_sort.cu`` (a stable counting sort over the
key's :data:`BIN_KEYS` values); on CPU tensors their plain twins run:
:func:`octant_cell_key` in torch ops, ``torch.argsort(stable=True)`` and
index ops, which the kernels equal bit for bit (``order`` is the stable
argsort's).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

__all__ = [
    "safe",
    "tile_aabbs",
    "BIN_CELLS",
    "BIN_THRESHOLD",
    "BIN_KEYS",
    "octant_cell_key",
    "sort_rays",
    "scatter_back",
    "run_binned",
]

#: position cells per axis of the sort key; kCells in csrc/wavefront_sort.cu
BIN_CELLS = 4

#: triangle count from which ``theia_tpu``'s MT and Woop queries sort
#: their rays by default (measured on a TPU); the port's sort only when
#: asked
BIN_THRESHOLD = 8192

#: values of the key: 8 direction octants x BIN_CELLS^3 position cells;
#: kKeys in csrc/wavefront_sort.cu
BIN_KEYS = 8 * BIN_CELLS**3

#: lanes a block of the sort's kernels counts and scatters; kTile in
#: csrc/wavefront_sort.cu
SORT_TILE = 1024

#: floats per row that the scatter back moves besides t and idx (the mt
#: query's winner rows, ``intersect_mt.ROW_WIDTH``)
ROW_WIDTH = 32


def safe(v: torch.Tensor) -> torch.Tensor:
    """Keep a slab test's reciprocal finite: components within 1e-20 of 0
    become +-1e-20 with their sign (-0.0 and 0 become +1e-20), so 0 * inf
    never turns a box test into NaN."""
    tiny = torch.where(v < 0.0, -1e-20, 1e-20)
    return torch.where(torch.abs(v) < 1e-20, tiny, v)


def tile_aabbs(v0, e1, e2, n_tri: int, n_tiles: int, bt: int) -> np.ndarray:
    """(n_tiles, 8) per-tile AABBs (lo xyz, pad, hi xyz, pad) over the
    real triangles, rounded outward to float32; all-padding tiles get an
    inverted box."""
    aabb = np.zeros((n_tiles, 8), np.float32)
    pts = np.concatenate(
        [v0[:n_tri], v0[:n_tri] + e1[:n_tri], v0[:n_tri] + e2[:n_tri]], axis=0
    )
    for k in range(n_tiles):
        s = slice(k * bt, min((k + 1) * bt, n_tri))
        if s.start >= n_tri:  # tile entirely padding
            aabb[k, 0:3] = 1.0
            aabb[k, 4:7] = -1.0
            continue
        p = np.concatenate([pts[s], pts[n_tri:][s], pts[2 * n_tri:][s]], axis=0)
        lo = p.min(0)
        hi = p.max(0)
        lo32 = lo.astype(np.float32)
        hi32 = hi.astype(np.float32)
        lo32 = np.where(lo32 > lo, np.nextafter(lo32, -np.inf), lo32)
        hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.inf), hi32)
        aabb[k, 0:3] = lo32
        aabb[k, 4:7] = hi32
    return aabb


def _grid(lo, hi) -> tuple[np.ndarray, np.ndarray]:
    """The key's grid on the host: float32 (lo, span) with span = max(hi -
    lo, 1e-6) in float32, as ``theia_tpu`` forms it."""
    lo, hi = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float32).reshape(3) for x in (lo, hi))
    return lo, np.maximum(hi - lo, np.float32(1e-6))


def octant_cell_key(lo, hi, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Sort key grouping coherent rays, int32 (N,): the direction octant
    (4 (d_x >= 0) + 2 (d_y >= 0) + (d_z >= 0)) times BIN_CELLS^3, plus the
    origin's cell on a BIN_CELLS^3 grid over the scene bounds ``lo``,
    ``hi``. Each cell index is ``(o - lo) / span * BIN_CELLS`` truncated
    toward zero and clipped to [0, BIN_CELLS - 1], with the float→int cast
    of XLA that ``theia_tpu`` takes: NaN gives 0 and values past the int32
    range saturate, so a NaN origin lands in cell 0 and an infinite one in
    0 or BIN_CELLS - 1 (torch's own cast gives INT_MIN for both). The plain
    twin of the key that ``csrc/wavefront_sort.cu`` computes."""
    lo, span = (torch.as_tensor(a, device=origin.device) for a in _grid(lo, hi))
    oct_ = (
        (direction[:, 0] >= 0).to(torch.int32) * 4
        + (direction[:, 1] >= 0).to(torch.int32) * 2
        + (direction[:, 2] >= 0).to(torch.int32)
    )
    x = (origin - lo) / span * BIN_CELLS
    # clamp first so that the cast is exact where XLA's saturates
    x = torch.where(torch.isnan(x), 0.0, torch.clamp(x, -1.0, float(BIN_CELLS)))
    q = torch.clamp(x.to(torch.int32), 0, BIN_CELLS - 1)
    cell = (q[:, 0] * BIN_CELLS + q[:, 1]) * BIN_CELLS + q[:, 2]
    return oct_ * BIN_CELLS**3 + cell


def _check(name: str, a: torch.Tensor, dtype, shape, device) -> None:
    if a.dtype != dtype or tuple(a.shape) != shape or not a.is_contiguous() or a.device != device:
        raise ValueError(f"{name} must be contiguous {dtype} of shape {shape} on {device}")


def sort_rays_plain(lo, hi, origin, direction, t_max):
    """Plain version of :func:`sort_rays`: the key, its stable argsort
    and the rays' gathers."""
    key = octant_cell_key(lo, hi, origin, direction)
    order = torch.argsort(key, stable=True)
    return key, order.to(torch.int32), origin[order], direction[order], t_max[order]


def sort_rays(lo, hi, origin: torch.Tensor, direction: torch.Tensor, t_max: torch.Tensor):
    """The wavefront sort: (key, order, origin, direction, t_max) with
    ``key`` each lane's :func:`octant_cell_key` (int32), ``order`` the
    stable argsort of it (int32) and the rays permuted by it. ``origin``,
    ``direction``: contiguous f32 (N, 3); ``t_max`` contiguous f32 (N,).
    CUDA tensors launch ``theia_wavefront_sort`` (three kernels, each over all
    the card's SMs; each call
    adds one to ``sort_rays.launches``), CPU tensors run
    :func:`sort_rays_plain`."""
    n, dev = origin.shape[0], origin.device
    for name, a, shape in (("origin", origin, (n, 3)), ("direction", direction, (n, 3)), ("t_max", t_max, (n,))):
        _check(name, a, torch.float32, shape, dev)
    if dev.type == "cpu":
        return sort_rays_plain(lo, hi, origin, direction, t_max)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lo, span = _grid(lo, hi)
    n_tiles = -(-n // SORT_TILE)
    scratch = torch.empty(n + (n_tiles + 1) * BIN_KEYS, dtype=torch.int32, device=dev)
    key, counts, totals = scratch[:n], scratch[n:-BIN_KEYS], scratch[-BIN_KEYS:]
    order = torch.empty(n, dtype=torch.int32, device=dev)
    o_s, d_s, t_s = torch.empty_like(origin), torch.empty_like(direction), torch.empty_like(t_max)
    err = _build.library().theia_wavefront_sort(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), *map(float, lo), *map(float, span), n,
        key.data_ptr(), counts.data_ptr(), totals.data_ptr(), order.data_ptr(), o_s.data_ptr(),
        d_s.data_ptr(), t_s.data_ptr(), _build.raw_stream(origin),
    )
    _build.check(err, "sort_rays")
    sort_rays.launches += int(n > 0)  # 0 lanes launch nothing
    return key, order, o_s, d_s, t_s


sort_rays.launches = 0


def scatter_back_plain(order, *outs):
    """Plain version of :func:`scatter_back`: ``out[order] = sorted``."""
    back = []
    for x in outs:
        y = torch.empty_like(x)
        y[order.long()] = x
        back.append(y)
    return tuple(back)


def scatter_back(order: torch.Tensor, t: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor | None = None):
    """A sorted query's outputs in lane order: (t, idx) or (t, idx, rows)
    with ``out[order[i]] = sorted[i]``; ``t`` f32 (N,), ``idx`` int32 (N,),
    ``rows`` f32 (N, 32). CUDA tensors launch ``theia_wavefront_scatter``
    (each call adds one to ``scatter_back.launches``), CPU tensors run
    :func:`scatter_back_plain`."""
    outs = (t, idx) if rows is None else (t, idx, rows)
    n, dev = order.shape[0], order.device
    if dev.type == "cpu":
        return scatter_back_plain(order, *outs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check("order", order, torch.int32, (n,), dev)
    _check("t", t, torch.float32, (n,), dev)
    _check("idx", idx, torch.int32, (n,), dev)
    if rows is not None:
        _check("rows", rows, torch.float32, (n, ROW_WIDTH), dev)
        if rows.data_ptr() % 16:
            raise ValueError("rows must be 16-byte aligned")
    back = tuple(torch.empty_like(x) for x in outs)
    err = _build.library().theia_wavefront_scatter(
        order.data_ptr(), t.data_ptr(), idx.data_ptr(), None if rows is None else rows.data_ptr(), n,
        back[0].data_ptr(), back[1].data_ptr(), None if rows is None else back[2].data_ptr(),
        _build.raw_stream(order),
    )
    _build.check(err, "scatter_back")
    scatter_back.launches += int(n > 0)
    return back


scatter_back.launches = 0


def run_binned(query, lo, hi, origin: torch.Tensor, direction: torch.Tensor, t_max):
    """Sort the wavefront by :func:`octant_cell_key`, run ``query(o, d,
    t_max) -> (t, idx)`` or ``(t, idx, rows)`` on the sorted rays, and
    scatter its outputs back to lane order. Bit-equal to ``query`` on the
    rays as they are, since each lane's result is its own. ``t_max``: a
    scalar or (N,). On CUDA tensors the sort and the scatter are the
    kernels of ``csrc/wavefront_sort.cu``, on CPU tensors their plain
    twins."""
    n = origin.shape[0]
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=origin.device), (n,)
    ).contiguous()
    _, order, o, d, tm = sort_rays(lo, hi, origin.contiguous(), direction.contiguous(), t_max)
    return scatter_back(order, *query(o, d, tm))
