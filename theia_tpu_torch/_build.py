"""Build and load the hand-written CUDA kernels of ``theia_tpu_torch``.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use
(never at import), goes to ``build/theia_tpu_torch/`` beside the package,
and is reused until the sources or flags change (the file name carries
their hash). A failed build raises with nvcc's output.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` turns a nonzero code
into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelLibrary", "library", "build", "check", "stream_handle", "raw_stream"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "theia_tpu_torch"
SOURCES = (
    "intersect_woop.cu", "intersect_soup.cu", "philox.cu", "histogram.cu",
    "kernel_histogram.cu", "table_read.cu",
)
#: -fmad=false: no contraction of a*b+c into FMAs, so every product and sum
#: rounds exactly as the plain PyTorch versions' separate ops do (explicit
#: fmaf intrinsics, as in the nearest-hit kernels' rejection tests, stay)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
#: argument types of each C entry point (pointers and the stream as void*)
_SIGNATURES = {
    "theia_woop_nearest": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    "theia_soup_nearest": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    "theia_soup_nearest_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    "theia_soup_anyhit": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "theia_soup_target": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P),
    "theia_philox_uniform": (_U, _U, _U, _U, _U, _U, _P, _P, _I, _I, _P, _P),
    "theia_histogram_add": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "theia_histogram_grad": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "theia_empty_launch": (_P,),
    "theia_kde_add": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "theia_kde_grad": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "theia_table_read": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    "theia_table_read_grad": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P),
    "theia_gather_rows": (_P, _I, _P, _I, _P, _P),
    "theia_gather_rows_grad": (_P, _I, _P, _I, _I, _P, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(csrc: Path, flags: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, path: Path, build_seconds: float, build_log: str, signatures: dict) -> None:
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log  # nvcc/ptxas report (registers, smem)
        self._lib = ctypes.CDLL(str(path))
        self._names = frozenset(signatures)
        for name, argtypes in signatures.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        if name in self._names:
            return getattr(self._lib, name)
        raise AttributeError(name)


def library() -> KernelLibrary:
    """The package's kernel library, built at first use; cached per process."""
    return build()


@functools.cache
def build(
    csrc: Path = CSRC, defines: tuple[str, ...] = (), signatures: tuple | None = None
) -> KernelLibrary:
    """Build (if needed) and load the sources of ``csrc`` with extra
    ``-D`` flags ``defines``; cached per process. Only measurement scripts
    pass arguments: another count of rays a block of the nearest-hit scan
    (``THEIA_RAYS_PER_THREAD``), the record's large-state variant on every
    state (``THEIA_HISTOGRAM_SHARED_MAX=0``), or the sources of an earlier
    commit or of a patched copy with their ``signatures`` as ``(name,
    argtypes)`` pairs, to time them beside the current kernels."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    sigs = dict(signatures) if signatures is not None else _SIGNATURES
    out = BUILD_DIR / f"libtheia_kernels-{_digest(csrc, flags)}.so"
    if out.is_file():
        return KernelLibrary(out, 0.0, "", sigs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    # the package's own build needs every source (nvcc fails on a missing
    # one); another directory (an earlier commit's) builds the sources it has
    sources = SOURCES if signatures is None else sorted(path.name for path in csrc.glob("*.cu"))
    objs = [BUILD_DIR / f"{Path(src).stem}-{tag}.o" for src in sources]
    start = time.perf_counter()
    # one nvcc per source, all running at once
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in (
            [nvcc, *flags, "-c", str(csrc / src), "-o", str(obj)]
            for src, obj in zip(sources, objs)
        )
    ]
    # wait for every compile before raising on any
    outputs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in compiles]
    log = "".join(_finish(*o) for o in outputs)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log += _finish(cmd, proc.stdout, proc.returncode)
    seconds = time.perf_counter() - start
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return KernelLibrary(out, seconds, log, sigs)


def _finish(cmd: list[str], output: str, returncode: int) -> str:
    """The output of one nvcc call; raises if it failed."""
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {returncode}:\n{' '.join(cmd)}\n{output}"
        )
    return output


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def raw_stream(t) -> int:
    """Raw handle of PyTorch's current stream on the device of the CUDA
    tensor ``t``: what :func:`stream_handle` gives, without building a
    ``torch.cuda.Stream`` (a call's few microseconds of host time)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
