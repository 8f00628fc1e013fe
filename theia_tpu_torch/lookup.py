"""Host-side table building (numpy/scipy).

Tables hold values at equidistant sample points over the normalized
coordinate range [0, 1]; the device reads them through
:func:`theia_tpu_torch.material.lookup_packed`. Same builders as
``theia_tpu.lookup`` (reference: src/theia/lookup.py:147-277).
"""

from __future__ import annotations

from typing import Literal

import numpy as np
from scipy.interpolate import CubicSpline

__all__ = ["sample_table1d", "eval_table"]


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

