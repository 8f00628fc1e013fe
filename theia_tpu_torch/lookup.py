"""Lookup tables: the device reads and the host-side builders.

Tables hold values at equidistant sample points over the normalized
coordinate range [0, 1]. :func:`lookup` interpolates one table per call
on the device (a single medium's tables, ``theia_tpu.lookup.lookup``);
a scene's packed tables are read through
:func:`theia_tpu_torch.material.lookup_packed`. :func:`lookup_dx` (value
and finite-difference slope) and :func:`lookup2d` (bilinear) are plain
PyTorch: no tracer reads them. The builders, :class:`Table` and
:func:`uploadTables` are ``theia_tpu.lookup``'s (reference:
src/theia/shader/lookup.glsl:4-113, src/theia/lookup.py:30-277), with
tensors on a device where JAX returns arrays.
"""

from __future__ import annotations

from typing import Literal

import warnings

import numpy as np
import torch
from scipy.interpolate import CloughTocher2DInterpolator, CubicSpline, LinearNDInterpolator, NearestNDInterpolator

from .component import resolve_device
from .ops.table_read import clip01, read_table

__all__ = [
    "lookup",
    "lookup_dx",
    "lookup2d",
    "as_table",
    "sample_table1d",
    "sample_table2d",
    "eval_table",
    "Table",
    "getTableSize",
    "uploadTables",
]


def as_table(table, device) -> torch.Tensor | None:
    """``table`` as a float32 tensor on ``device`` (a tensor already so is
    returned as it is, so that its gradient flows), or None for a null
    table (``None`` or empty)."""
    if table is None:
        return None
    table = torch.as_tensor(table, dtype=torch.float32, device=device)
    return None if table.shape[-1] == 0 else table.contiguous()


def lookup(table, u: torch.Tensor, null_value=0.0, *, affine=None) -> torch.Tensor:
    """Linearly interpolate ``table`` (``n`` equidistant samples over
    [0, 1]; a tensor on ``u``'s device, differentiable in its values, or
    a host array, which is copied there) at the normalized
    coordinates ``u``, clamped to [0, 1]; with ``affine=(a, b)`` at ``a *
    u + b``, formed in the same launch (``ops.table_read.PHASE`` for the
    phase reads' ``0.5 * (cos_theta + 1)``). ``None`` (or an empty table)
    returns ``null_value`` (the reference's null-pointer convention). The
    same ops in the same order as ``theia_tpu.lookup.lookup``: ``v_lo *
    (1 - l) + v_hi * l``, through :func:`~theia_tpu_torch.ops.table_read.read_table`
    (a kernel on the card, with its backward), differentiable in the
    table and in ``u`` with ``jnp.clip``'s gradient at the bounds."""
    table = as_table(table, u.device)
    if table is None:
        return torch.full_like(u, null_value)
    return read_table(table, u, null_value, affine=affine)


def _take(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, index, axis=-1)``: shape ``table.shape[:-1] +
    index.shape``."""
    return table[..., index]


def lookup_dx(table, u: torch.Tensor, null_value=(0.0, 0.0)) -> tuple[torch.Tensor, torch.Tensor]:
    """Interpolated value and finite-difference slope d/du of ``table`` at
    ``u`` (clamped to [0, 1]): central differences, one-sided at the
    borders (reference: src/theia/shader/lookup.glsl:34-73), in the same
    ops and order as ``theia_tpu.lookup.lookup_dx``. ``None`` gives
    ``null_value``."""
    table = as_table(table, u.device)
    if table is None:
        zero = torch.zeros_like(u, dtype=torch.float32)
        return zero + null_value[0], zero + null_value[1]
    n = table.shape[-1]
    u = clip01(u.to(torch.float32)) * float(n - 1)
    lo = torch.clamp_min(torch.floor(u).to(torch.int64), 0)
    hi = torch.clamp_max(lo + 1, n - 1)
    l = u - torch.floor(u)
    lolo = torch.clamp_min(lo - 1, 0)
    hihi = torch.clamp_max(hi + 1, n - 1)
    v_lolo, v_lo, v_hi, v_hihi = (_take(table, i) for i in (lolo, lo, hi, hihi))
    dx_lo = (v_hi - v_lolo) / torch.clamp_min(hi - lolo, 1).to(torch.float32)
    dx_hi = (v_hihi - v_lo) / torch.clamp_min(hihi - lo, 1).to(torch.float32)
    value = v_lo * (1.0 - l) + v_hi * l
    dx = (dx_lo * (1.0 - l) + dx_hi * l) * float(n - 1)
    return value, dx


def lookup2d(table, u: torch.Tensor, v: torch.Tensor, null_value=0.0) -> torch.Tensor:
    """Bilinearly interpolate a 2-D table of shape (..., nu, nv) at (u, v)
    in [0, 1]^2 (each clamped); axis -2 is u, axis -1 is v (numpy's row
    order, as the reference reads it). The same ops in the same order as
    ``theia_tpu.lookup.lookup2d``; ``None`` gives ``null_value``."""
    if table is None:
        return torch.full_like(u, null_value, dtype=torch.float32)
    table = torch.as_tensor(table, dtype=torch.float32, device=u.device)
    nu, nv = table.shape[-2], table.shape[-1]
    u = clip01(u.to(torch.float32)) * float(nu - 1)
    v = clip01(v.to(torch.float32)) * float(nv - 1)
    u_lo, u_hi = torch.floor(u).to(torch.int64), torch.ceil(u).to(torch.int64)
    v_lo, v_hi = torch.floor(v).to(torch.int64), torch.ceil(v).to(torch.int64)
    ul = u - torch.floor(u)
    vl = v - torch.floor(v)
    flat = table.reshape(*table.shape[:-2], nu * nv)
    q11 = _take(flat, u_lo * nv + v_lo)
    q12 = _take(flat, u_hi * nv + v_lo)
    q21 = _take(flat, u_lo * nv + v_hi)
    q22 = _take(flat, u_hi * nv + v_hi)
    lo = q11 * (1.0 - ul) + q12 * ul
    hi = q21 * (1.0 - ul) + q22 * ul
    return lo * (1.0 - vl) + hi * vl


def _parse_boundary(data: np.ndarray, boundary, n: int) -> np.ndarray:
    if boundary is None:
        return np.linspace(data.min(), data.max(), n)
    if isinstance(boundary, tuple) and len(boundary) == 2:
        return np.linspace(boundary[0], boundary[1], n)
    raise ValueError("Can't parse given boundaries!")


def sample_table1d(
    data,
    nx: int = 1024,
    *,
    boundary=None,
    mode: Literal["linear", "cubic"] = "linear",
) -> np.ndarray:
    """Resample scattered (x, f(x)) data of shape (N, 2) onto ``nx``
    equidistant points; returns the float32 table values."""
    data = np.asarray(data)
    x = _parse_boundary(data[:, 0], boundary, nx)
    if mode == "linear":
        return np.interp(x, data[:, 0], data[:, 1]).astype(np.float32)
    if mode == "cubic":
        return CubicSpline(data[:, 0], data[:, 1])(x).astype(np.float32)
    raise ValueError("Unknown interpolation mode!")


def sample_table2d(
    data,
    nx: int = 1024,
    ny: int = 1024,
    *,
    boundaries=None,
    mode: Literal["linear", "cubic"] = "linear",
) -> np.ndarray:
    """Resample scattered (x, y, f(x, y)) data of shape (N, 3) onto a
    regular grid; returns float32 values of shape (ny, nx): axis 0 is the
    SECOND input column (the reference's meshgrid-'xy' order, pinned by its
    tests), so ``lookup2d(table, u, v)`` reads u = normalized y and v =
    normalized x. Grid points outside the data's convex hull are filled by
    nearest neighbour, with a warning (``theia_tpu.lookup.sample_table2d``)."""
    data = np.asarray(data)
    if boundaries is None:
        x = _parse_boundary(data[:, 0], None, nx)
        y = _parse_boundary(data[:, 1], None, ny)
    elif isinstance(boundaries, tuple) and len(boundaries) == 2:
        x = _parse_boundary(data[:, 0], boundaries[0], nx)
        y = _parse_boundary(data[:, 1], boundaries[1], ny)
    else:
        raise ValueError("Can't parse given boundaries!")
    xg, yg = np.meshgrid(x, y)
    if mode == "linear":
        model = LinearNDInterpolator
    elif mode == "cubic":
        model = CloughTocher2DInterpolator
    else:
        raise ValueError("Unknown interpolation mode!")
    values = model(data[:, :2], data[:, 2])(xg, yg).astype(np.float32)
    # outside the hull scipy's simplex interpolators give NaN, which would
    # poison every read that touches the cell
    bad = ~np.isfinite(values)
    if bad.any():
        warnings.warn(
            f"sample_table2d: {int(bad.sum())} grid points outside the "
            "convex hull of the data; filled by nearest neighbor"
        )
        nearest = NearestNDInterpolator(data[:, :2], data[:, 2])
        values[bad] = nearest(xg[bad], yg[bad]).astype(np.float32)
    return values


def eval_table(f, *axes_spec) -> np.ndarray:
    """Sample ``f`` on a regular grid; each axis spec is either ``n`` (grid
    over [0,1]) or ``(min, max, n)``. Returns float32 values with axis k
    matching spec k ('ij' indexing)."""

    def make_axis(spec):
        if isinstance(spec, int):
            return np.linspace(0.0, 1.0, spec)
        if isinstance(spec, tuple) and len(spec) == 3:
            return np.linspace(*spec)
        raise ValueError(f"Cannot parse dimension: {spec}")

    axes = [make_axis(a) for a in axes_spec]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.asarray(f(*grid), dtype=np.float32)



# the reference's names (src/theia/lookup.py)
sampleTable1D = sample_table1d
sampleTable2D = sample_table2d
evalTable = eval_table


class Table:
    """Host-side equidistant lookup table (reference: src/theia/lookup.py:
    30-81): the sampled values as float32; :meth:`upload` gives the tensor
    that :func:`lookup` / :func:`lookup2d` read. ``nbytes`` counts the
    reference's layout on the device (an int32 header a dimension and the
    float32 data)."""

    ALIGNMENT = 4

    def __init__(self, data) -> None:
        self._data = np.ascontiguousarray(data, dtype=np.float32)

    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def shape(self) -> tuple:
        return self._data.shape

    @property
    def nbytes(self) -> int:
        return self._data.nbytes + 4 * self._data.ndim

    def upload(self, device="cuda") -> torch.Tensor:
        """The table as a float32 tensor on ``device`` (the card unless
        the caller names another)."""
        return torch.as_tensor(self._data, device=resolve_device(device))


def getTableSize(a) -> int:
    """Bytes that a table of the given shape takes (an array, a shape
    tuple, or None -> 0): an int32 header a dimension plus the float32
    data, for any rank (``theia_tpu.lookup.getTableSize``)."""
    if a is None:
        return 0
    shape = a if isinstance(a, tuple) else np.shape(a)
    if len(shape) == 0:
        raise RuntimeError("table cannot have zero shape!")
    return 4 * (len(shape) + int(np.prod(shape)))


def uploadTables(data: list, device="cuda") -> tuple[tuple[torch.Tensor, torch.Tensor], list[int]]:
    """Pack 1-D tables into one zero-padded (K, L) float32 tensor and their
    sizes into an int32 (K,) tensor on ``device``, with integer handles:
    ``theia_tpu.lookup.uploadTables``' (values, sizes) pair, which
    :func:`~theia_tpu_torch.material.lookup_packed` reads."""
    device = resolve_device(device)
    arrs = [np.ascontiguousarray(d, np.float32).reshape(-1) for d in data]
    lmax = max((len(a) for a in arrs), default=1)
    values = np.zeros((len(arrs), lmax), np.float32)
    sizes = np.zeros(len(arrs), np.int32)
    for i, a in enumerate(arrs):
        values[i, : len(a)] = a
        sizes[i] = len(a)
    return (torch.as_tensor(values, device=device), torch.as_tensor(sizes, device=device)), list(range(len(arrs)))
