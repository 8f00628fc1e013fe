"""Reference queue-item layouts as numpy structured dtypes, as
``theia_tpu.items``.

The reference describes every queue record as a ctypes ``Structure``
(array-of-structures rows, e.g. src/theia/response.py:55-92,
src/theia/camera.py:78-104, src/theia/light.py:81-84, 463-492); the
port's results are structure-of-arrays dicts of tensors. Each class here
carries the reference's exact field layout as a numpy structured dtype
plus :meth:`from_queue`, which compacts a result dict (tensors on any
device, or arrays) into AoS rows, so that tooling written against the
reference's binary record format (np.fromfile / ctypes casts) keeps
working on arrays saved this way.

Field names follow the reference; ``_rename`` maps them to the SoA keys
the port's components emit where they differ (e.g. ``polarizationRef`` vs
``polRef``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "to_structured",
    "WavelengthSampleItem",
    "LightSampleItem",
    "PolarizedLightSampleItem",
    "CameraRayItem",
    "PolarizedCameraRayItem",
    "PolarizedHitItem",
    "HitTimeItem",
    "HitTimeAndIdItem",
    "ValueItem",
    "CameraHitResponseItem",
    "PolarizedCameraHitResponseItem",
]

_f = np.float32
_i = np.int32


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_structured(queue: dict, dtype: np.dtype, rename: dict | None = None):
    """Compact a SoA result dict into AoS rows of the given layout.

    Rows with ``valid == False`` (when the dict carries a mask) are
    dropped; fields are matched by name via ``rename`` falling back to
    the identical key."""
    rename = rename or {}
    valid = queue.get("valid")
    valid = None if valid is None else _host(valid).astype(bool)
    n = None
    cols = {}
    for field in dtype.names:
        key = rename.get(field, field)
        if key not in queue:
            raise KeyError(
                f"result dict has no column {key!r} for field {field!r}"
            )
        col = _host(queue[key])
        if valid is not None:
            col = col[valid]
        cols[field] = col
        n = len(col) if n is None else n
    out = np.zeros(n, dtype)
    for field, col in cols.items():
        out[field] = col.reshape((n,) + out.dtype[field].shape)
    return out


class _Item:
    dtype: np.dtype
    _rename: dict = {}

    @classmethod
    def from_queue(cls, queue: dict) -> np.ndarray:
        """AoS rows (reference record layout) from a SoA result dict."""
        return to_structured(queue, cls.dtype, cls._rename)


class WavelengthSampleItem(_Item):
    """(wavelength, contrib) — reference light.py:81-84."""

    dtype = np.dtype([("wavelength", _f), ("contrib", _f)])


class LightSampleItem(_Item):
    """Unpolarized light sample — reference light.py:463-471."""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("startTime", _f),
            ("contrib", _f),
        ]
    )


class PolarizedLightSampleItem(_Item):
    """Polarized light sample — reference light.py:474-492."""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("stokes", _f, (4,)),
            ("polarizationRef", _f, (3,)),
            ("startTime", _f),
            ("contrib", _f),
        ]
    )
    _rename = {"polarizationRef": "polRef"}


class CameraRayItem(_Item):
    """Camera ray sample — reference camera.py:78-88."""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("contrib", _f),
            ("timeDelta", _f),
            ("hitPosition", _f, (3,)),
            ("hitDirection", _f, (3,)),
            ("hitNormal", _f, (3,)),
            ("objectId", _i),
        ]
    )


class PolarizedCameraRayItem(_Item):
    """Polarized camera ray sample — reference camera.py:91-104."""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("contrib", _f),
            ("timeDelta", _f),
            ("polarizationRef", _f, (3,)),
            ("mueller", _f, (4, 4)),
            ("hitPolRef", _f, (3,)),
            ("hitPosition", _f, (3,)),
            ("hitDirection", _f, (3,)),
            ("hitNormal", _f, (3,)),
            ("objectId", _i),
        ]
    )
    _rename = {"polarizationRef": "polRef"}


class PolarizedHitItem(_Item):
    """Detector hit with polarization — reference response.py:73-92."""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("normal", _f, (3,)),
            ("stokes", _f, (4,)),
            ("polarizationRef", _f, (3,)),
            ("wavelength", _f),
            ("time", _f),
            ("contrib", _f),
            ("objectId", _i),
        ]
    )
    _rename = {"polarizationRef": "polRef"}


class HitItemLayout(_Item):
    """Unpolarized detector hit — reference response.py:55-70. (Named
    ``HitItem`` there; here the SoA wavefront form keeps that name, see
    ``theia_tpu_torch.trace.core.HitItem``.)"""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("normal", _f, (3,)),
            ("wavelength", _f),
            ("time", _f),
            ("contrib", _f),
            ("objectId", _i),
        ]
    )


class HitTimeItem(_Item):
    """StoreTimeHitResponse record — reference response.py:626-629."""

    dtype = np.dtype([("time", _f)])


class HitTimeAndIdItem(_Item):
    """StoreTimeHitResponse record with id — reference response.py:632-635."""

    dtype = np.dtype([("time", _f), ("objectId", _i)])


class ValueItem(_Item):
    """Estimator input record — reference response.py:425-431."""

    dtype = np.dtype([("value", _f), ("time", _f)])


class CameraHitResponseItem(_Item):
    """CameraHitResponseSampler record — reference response.py:884-892."""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("normal", _f, (3,)),
            ("wavelength", _f),
            ("timeDelta", _f),
            ("contrib", _f),
        ]
    )


class PolarizedCameraHitResponseItem(_Item):
    """Polarized variant — reference response.py:895-905."""

    dtype = np.dtype(
        [
            ("position", _f, (3,)),
            ("direction", _f, (3,)),
            ("normal", _f, (3,)),
            ("wavelength", _f),
            ("timeDelta", _f),
            ("contrib", _f),
            ("polarizationRef", _f, (3,)),
            ("stokes", _f, (4,)),
        ]
    )
    _rename = {"polarizationRef": "polRef"}
