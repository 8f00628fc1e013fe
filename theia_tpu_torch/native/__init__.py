"""Native (C++) host code of the port: the threaded-BVH builder.

``bvh.cpp`` is the port's own copy of ``theia_tpu``'s builder. It is
compiled with ``g++`` at first use into ``build/theia_tpu_torch/`` beside
the package (the file name carries a hash of the source and the flags)
and loaded with ``ctypes``; a failed compile raises with g++'s output.
:func:`_build_numpy` is its numpy twin, decision for decision, which the
tests hold the compiled builder against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR

__all__ = ["BVH", "build_bvh", "native_available"]

SOURCE = Path(__file__).resolve().parent / "bvh.cpp"
#: no contraction of a*b+c: the SAH costs round as the numpy twin's do
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")


@functools.cache
def _library() -> ctypes.CDLL:
    """The compiled builder, built at first use; cached per process."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libtheia_bvh-{digest}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.bvh_node_count.restype = ctypes.c_int32
    lib.bvh_node_count.argtypes = [f32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32]
    lib.bvh_build.restype = ctypes.c_int32
    lib.bvh_build.argtypes = [
        f32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32, f32p, f32p, i32p, i32p, i32p, i32p,
    ]
    return lib


def native_available() -> bool:
    """Whether the compiled builder builds and loads here (``g++`` on the
    path and the compile passing): ``theia_tpu.native.native_available``."""
    try:
        _library()
    except (OSError, RuntimeError):
        return False
    return True


@dataclass
class BVH:
    """Flat threaded BVH: on AABB hit continue at node+1, on miss (or after
    a leaf) jump to ``miss``; -1 terminates. Leaves reference a contiguous
    range of ``order`` (permuted triangle ids)."""

    bmin: np.ndarray  # (M, 3) f32
    bmax: np.ndarray  # (M, 3) f32
    miss: np.ndarray  # (M,) i32
    start: np.ndarray  # (M,) i32, -1 for interior
    count: np.ndarray  # (M,) i32
    order: np.ndarray  # (T,) i32


_SAH_BINS = 16


def _build_numpy(v0, e1, e2, leaf_size: int) -> BVH:
    """The numpy twin of ``bvh.cpp`` (``theia_tpu.native._build_numpy``).

    Split strategy: binned SAH (16 bins over the widest centroid axis,
    areas/costs accumulated in float64 over exact float32 bounds so both
    builders make bit-identical decisions), with a median split fallback
    when the SAH cannot separate the range (degenerate centroids or an
    empty side)."""
    n = len(v0)
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (T, 3verts, 3)
    tlo = pts.min(1)
    thi = pts.max(1)
    cent = v0 + (e1 + e2) / np.float32(3.0)
    order = np.arange(n, dtype=np.int32)

    bmin, bmax, miss, start, count = [], [], [], [], []

    def _half_area(lo3, hi3):
        d = np.asarray(hi3, np.float64) - np.asarray(lo3, np.float64)
        if (d < 0).any():
            return 0.0
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def build(lo, hi, miss_to):
        node = len(miss)
        sel = order[lo:hi]
        bmin.append(tlo[sel].min(0))
        bmax.append(thi[sel].max(0))
        miss.append(miss_to)
        start.append(-1)
        count.append(0)
        if hi - lo <= leaf_size:
            start[node] = lo
            count[node] = hi - lo
            return
        c = cent[sel]
        clo = c.min(0)
        chi = c.max(0)
        widths = chi - clo
        axis = int(np.argmax(widths))
        width = np.float32(widths[axis])

        mid = -1
        if width > 0.0:
            # binned SAH over the widest centroid axis
            scale = np.float32(_SAH_BINS) / width
            idx = ((c[:, axis] - clo[axis]) * scale).astype(np.int32)
            idx = np.minimum(idx, _SAH_BINS - 1)
            nb = np.bincount(idx, minlength=_SAH_BINS)
            blo = np.full((_SAH_BINS, 3), np.float32(1e38))
            bhi = np.full((_SAH_BINS, 3), np.float32(-1e38))
            for b in range(_SAH_BINS):
                m = idx == b
                if m.any():
                    blo[b] = tlo[sel[m]].min(0)
                    bhi[b] = thi[sel[m]].max(0)
            best_cost, best_k = np.inf, -1
            for k in range(_SAH_BINS - 1):
                n_l = int(nb[: k + 1].sum())
                n_r = int(nb[k + 1 :].sum())
                if n_l == 0 or n_r == 0:
                    continue
                a_l = _half_area(blo[: k + 1].min(0), bhi[: k + 1].max(0))
                a_r = _half_area(blo[k + 1 :].min(0), bhi[k + 1 :].max(0))
                cost = a_l * n_l + a_r * n_r
                if cost < best_cost:
                    best_cost, best_k = cost, k
            if best_k >= 0:
                left = idx <= best_k  # stable partition
                order[lo:hi] = np.concatenate([sel[left], sel[~left]])
                mid = lo + int(left.sum())
        if mid < 0:
            # median fallback: degenerate centroids or SAH found no split
            mid = (lo + hi) // 2
            k = mid - lo
            part = np.argpartition(c[:, axis], k if k < len(sel) else len(sel) - 1)
            order[lo:hi] = sel[part]
        placeholder = -2 - node
        left_first = len(miss)
        build(lo, mid, placeholder)
        right_first = len(miss)
        for i in range(left_first, right_first):
            if miss[i] == placeholder:
                miss[i] = right_first
        build(mid, hi, miss_to)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        build(0, n, -1)
    finally:
        sys.setrecursionlimit(old)
    return BVH(
        bmin=np.asarray(bmin, np.float32),
        bmax=np.asarray(bmax, np.float32),
        miss=np.asarray(miss, np.int32),
        start=np.asarray(start, np.int32),
        count=np.asarray(count, np.int32),
        order=order,
    )


def build_bvh(v0, e1, e2, *, leaf_size: int = 4) -> BVH:
    """Build a threaded BVH over triangles given as (v0, e1, e2) arrays
    with the compiled builder."""
    v0, e1, e2 = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    n = len(v0)
    lib = _library()
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    fp = lambda a: a.ctypes.data_as(f32p)
    ip = lambda a: a.ctypes.data_as(i32p)
    m = lib.bvh_node_count(fp(v0), fp(e1), fp(e2), n, leaf_size)
    bmin = np.empty((m, 3), np.float32)
    bmax = np.empty((m, 3), np.float32)
    miss, start, count = (np.empty(m, np.int32) for _ in range(3))
    order = np.empty(n, np.int32)
    lib.bvh_build(fp(v0), fp(e1), fp(e2), n, leaf_size, fp(bmin), fp(bmax), ip(miss), ip(start), ip(count), ip(order))
    return BVH(bmin, bmax, miss, start, count, order)
