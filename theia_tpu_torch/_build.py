"""Build and load the hand-written CUDA kernels of ``theia_tpu_torch``.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with a
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

__all__ = ["KernelLibrary", "library", "check", "stream_handle"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "theia_tpu_torch"
SOURCES = ("intersect_mt.cu", "philox.cu", "histogram.cu")
#: -fmad=false: no contraction of a*b+c into FMAs, so every product and sum
#: rounds exactly as the plain PyTorch versions' separate ops do
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
#: argument types of each C entry point (pointers and the stream as void*)
_SIGNATURES = {
    "theia_mt_nearest": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "theia_philox_uniform": (_U, _U, _U, _U, _U, _U, _P, _P, _I, _I, _P, _P),
    "theia_histogram_add": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, path: Path, build_seconds: float, build_log: str) -> None:
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log  # nvcc/ptxas report (registers, smem)
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        if name in _SIGNATURES:
            return getattr(self._lib, name)
        raise AttributeError(name)


@functools.cache
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    out = BUILD_DIR / f"libtheia_kernels-{_digest()}.so"
    if out.is_file():
        return KernelLibrary(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return KernelLibrary(out, seconds, proc.stdout + proc.stderr)


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
