"""theia_tpu_torch — the PyTorch/CUDA port of theia_tpu.

A second package beside ``theia_tpu`` (the JAX reference) with the same
module layout and public names, so the same builder code drives either.
Plain tensor code is PyTorch; the hot kernels of the scene tracer's main
path (the nearest-hit and any-hit scans over the triangle soup, the
instanced and BVH walks, Philox and Owen-scrambled Sobol draws, the
histogram record and its backward, the kernel histogram and the table
reads with their backward, the gamma draw of a cascade's depth, a
Cherenkov track's backward sample and the wavefront sort)
are hand-written CUDA kernels for Hopper in ``csrc/``, built with nvcc at
first use (the BVH builder in ``native/`` with g++). On CPU tensors
every kernel's plain PyTorch version runs instead. This package never
imports jax or theia_tpu.

Ported so far: the scene forward tracer, guided or not, unpolarized and
polarized, on the default brute-force scene (``accel="auto"``), with
``accel="mt"`` or ``accel="woop"``, and on the two-level instanced walk
(what ``"auto"`` picks for a detector array) and the threaded BVH
(``accel="instanced"``, ``accel="bvh"``); the volume forward tracer and
the two photon tracers on analytic targets and scenes; the volume backward
and direct-light tracers with the cameras; the scene backward tracers
(``SceneBackwardTargetTracer``, ``SceneBackwardTracer``) and the
bidirectional path tracer, with the light-source targets; any tracer with
``PhiloxRNG`` or ``SobolQRNG``; the forward tracers'
gradients through ``trace_fn()`` (medium tables, phase and refractive
index, group velocity, source and detector position); Cherenkov light
from tracks, muons and cascades (``cascades``), the host-fed and
tabulated sources, the planar target guides and the value queue with its
estimators; mesh files, material archives and the ocean-water phase
functions, 2-D tables, the samplers of ``testing``, the debug renderer
``render.SceneRender``, ``pipeline`` with its scheduler, tasks and
checkpoints, the multi-device layer ``parallel`` (``ShardedRunner`` over
``torch.distributed``, one process a device), ``profiling`` on
``torch.profiler`` and the wavefront sort of the MT and Woop queries
(``ops._intersect_tiles.run_binned``): every module of ``theia_tpu``.
"""

from . import units
from .random import PhiloxRNG, RNGState, SobolQRNG, SobolState

__version__ = "0.1.0"

#: submodules reachable as ``theia_tpu_torch.<name>`` without an explicit
#: import, loaded lazily so importing the root stays cheap
_SUBMODULES = {
    "accel", "callback", "camera", "cascades", "component", "interop", "items", "light", "lookup",
    "material", "mesh", "ops", "parallel", "pipeline", "polarization", "profiling", "random", "render",
    "response", "scene", "target", "task", "testing", "trace",
}

__all__ = sorted(_SUBMODULES | {"units", "PhiloxRNG", "RNGState", "SobolQRNG", "SobolState"})


def __getattr__(name: str):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
