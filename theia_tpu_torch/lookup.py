"""Lookup tables: the device read and the host-side builders.

Tables hold values at equidistant sample points over the normalized
coordinate range [0, 1]. :func:`lookup` interpolates one table per call
on the device (a single medium's tables, ``theia_tpu.lookup.lookup``);
a scene's packed tables are read through
:func:`theia_tpu_torch.material.lookup_packed`. The builders are
``theia_tpu.lookup``'s (reference: src/theia/shader/lookup.glsl:4-32,
src/theia/lookup.py:147-277).
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from scipy.interpolate import CubicSpline

from .ops.table_read import read_table

__all__ = ["lookup", "as_table", "sample_table1d", "eval_table"]


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

