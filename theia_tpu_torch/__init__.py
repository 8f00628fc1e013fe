"""theia_tpu_torch — the PyTorch/CUDA port of theia_tpu.

A second package beside ``theia_tpu`` (the JAX reference) with the same
module layout and public names, so the same builder code drives either.
Plain tensor code is PyTorch; the hot kernels of the scene tracer's main
path (the nearest-hit and any-hit scans over the triangle soup, Philox
draws, the histogram record and its backward, the kernel histogram and
the table reads with their backward) are hand-written CUDA kernels for
Hopper in ``csrc/``, built with nvcc at first use. On CPU tensors every
kernel's plain PyTorch version runs instead. This package never imports
jax or theia_tpu.

Ported so far: the scene forward tracer, guided or not, unpolarized and
polarized, on the default brute-force scene (``accel="auto"``) and with
``accel="mt"`` or ``accel="woop"``; the volume forward tracer and the two
photon tracers on analytic targets and scenes; the forward tracers'
gradients through ``trace_fn()`` (medium tables, phase and refractive
index, group velocity, source and detector position) (see ROADMAP.md
for what comes next).
"""

from . import units
from .random import PhiloxRNG, RNGState

__version__ = "0.1.0"

#: submodules reachable as ``theia_tpu_torch.<name>`` without an explicit
#: import, loaded lazily so importing the root stays cheap
_SUBMODULES = {
    "accel", "callback", "component", "interop", "light", "lookup",
    "material", "mesh", "ops", "random", "response", "scene", "target", "testing",
    "trace",
}

__all__ = sorted(_SUBMODULES | {"units", "PhiloxRNG", "RNGState"})


def __getattr__(name: str):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
