"""One rank of a gloo world for the port's sharded tests, and the builders
of the tracers those tests shard.

    python tests/_torch_parallel_worker.py INIT_URL WORLD RANK OUT_DIR JOB[,JOB...]

joins a ``WORLD``-rank gloo group at ``INIT_URL`` (a ``file://`` URL; no
port is fixed) through ``theia_tpu_torch.parallel.initialize`` with a 60 s
timeout, runs each named job of :data:`JOBS` on the CPU with one thread,
and saves its results to ``OUT_DIR/<job>-<rank>.pt``. ``start_world``
starts such a world and ``join_world`` waits for it (with a timeout) and
raises with a rank's output if any rank failed.

The builders take the package (``theia_tpu`` or ``theia_tpu_torch``) as
their first argument, so a test builds JAX's twin of a tracer with the
same code; this module imports nothing of ``theia_tpu`` itself.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent

#: seconds a world may take before join_world kills it
WORLD_TIMEOUT = 600.0


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _dev(device):
    return {} if device is None else {"device": device}


def hg_medium(pkg, mu_a: float, mu_s: float, g: float):
    """``tests/test_parallel.py``'s model: dispersion-free water (n = ng =
    1.33) with a Henyey-Greenstein phase function, tables 64 x 64."""
    m = _mod(pkg, "material")

    class Model(m.DispersionFreeMedium, m.HenyeyGreensteinPhaseFunction, m.MediumModel):
        def __init__(self):
            m.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=mu_a, mu_s=mu_s)
            m.HenyeyGreensteinPhaseFunction.__init__(self, g)

    return Model().createMedium(num_lambda=64, num_theta=64)


def build_volume(pkg, batch: int, device=None, *, callback: bool = True):
    """``tests/test_parallel.py``'s ``build``: a flash at the centre of a
    60 m inner sphere, 4 scatterings, 40 bins of 20 ns, event statistics."""
    light, target, response = (_mod(pkg, n) for n in ("light", "target", "response"))
    kw = dict(callback=_mod(pkg, "callback").EventStatisticCallback()) if callback else {}
    return _mod(pkg, "trace").VolumeForwardTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        target.InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=60.0),
        light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        response.HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0),
        pkg.random.PhiloxRNG(key=0xC0FFEE),
        medium=hg_medium(pkg, 0.01, 0.01, 0.4),
        nScattering=4,
        scatterCoefficient=0.02,
        **kw,
        **_dev(device),
    )


def build_streaming(pkg, batch: int, device=None):
    """``tests/test_parallel.py``'s streaming-source tracer: four blocks of
    host wavelengths, 2 scatterings."""
    import numpy as np

    light, target, response = (_mod(pkg, n) for n in ("light", "target", "response"))
    wl = np.linspace(400.0, 500.0, 4 * batch, dtype=np.float32)
    src = light.StreamingHostWavelengthSource(wl, batchSize=batch)
    tracer = _mod(pkg, "trace").VolumeForwardTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        target.InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=60.0),
        src,
        response.HistogramHitResponse(nBins=10, t0=0.0, binSize=50.0),
        pkg.random.PhiloxRNG(key=0xC0DE),
        medium=hg_medium(pkg, 0.01, 0.01, 0.4),
        nScattering=2,
        scatterCoefficient=0.02,
        **_dev(device),
    )
    return tracer, src


def build_pipeline_tracer(pkg, batch: int, device=None):
    """``tests/test_sharded_pipeline.py``'s ``build``: a flash at the
    centre of a 50 m inner sphere, 6 scatterings, 40 bins of 20 ns."""
    light, target, response = (_mod(pkg, n) for n in ("light", "target", "response"))
    return _mod(pkg, "trace").VolumeForwardTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        target.InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=50.0),
        light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        response.HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0),
        pkg.random.PhiloxRNG(key=0xC0FFEE),
        medium=hg_medium(pkg, 0.005, 0.01, 0.3),
        nScattering=6,
        scatterCoefficient=0.02,
        **_dev(device),
    )


def build_instanced(pkg, batch: int, device=None):
    """``tests/test_parallel.py``'s instanced scene on an in-code sphere
    (``icosphere(2)``, where the JAX test loads sphere.stl): four detector
    spheres of radius 0.5 on a 2 x 2 grid around a flash, in water with
    mu_s 0.03, path length 4, 20 bins of 4 ns."""
    sys.path.insert(0, str(TESTS))
    from torch_flagship import icosphere

    material, scene_mod = _mod(pkg, "material"), _mod(pkg, "scene")
    light, response = _mod(pkg, "light"), _mod(pkg, "response")
    medium = _mod(pkg, "testing").WaterTestModel(mu_a=0.0, mu_s=0.03, g=0.0).createMedium()
    store = material.MaterialStore.pack([material.Material("det", None, medium, flags="DB")], **_dev(device))
    meshes = scene_mod.MeshStore({"sphere": _mod(pkg, "mesh").Mesh.from_geometry(*icosphere(2))})
    T = scene_mod.Transform
    insts = [
        meshes.createInstance("sphere", "det", T.TRS(scale=0.5, translate=(2.0 * i - 1, 2.0 * j - 1, 0.0)))
        for i in range(2) for j in range(2)
    ]
    scene = scene_mod.Scene(insts, store, medium="water_test", accel="instanced", **_dev(device))
    return _mod(pkg, "trace").SceneForwardTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        response.HistogramHitResponse(nBins=20, t0=0.0, binSize=4.0),
        pkg.random.PhiloxRNG(key=0xFACE),
        scene,
        maxPathLength=4,
        maxTime=80.0,
        **_dev(device),
    )


#: batches and sizes of the tests' cases
PARALLEL_BATCH = 8 * 1024
GRAD_BATCH = 4 * 1024
INSTANCED_BATCH = 4 * 1024
PIPELINE_BATCH = 8 * 1024
CONVERGE = dict(initialBatchCount=3, extraBatchCount=2, maxBatchCount=12, atol=0.0, rtol=3e-3)


def absorption_grad(tracer, fn, streams):
    """d sum(hist) / d absorption_coef on ``streams`` through ``fn`` (the
    tracer's ``_trace_batch`` or :func:`shard_trace`'s), a local backward:
    the table's ``.grad`` is this rank's share."""
    p0 = tracer.params()
    tbl = p0["medium"].absorption_coef.detach().clone().requires_grad_(True)
    p = dict(p0, medium=dataclasses.replace(p0["medium"], absorption_coef=tbl))
    hist = fn(p, tracer.rng.counter_words, streams)[0]
    hist.sum().backward()
    return tbl


def job_volume(P, mesh, out_dir: Path):
    """sharded equals single: the summed histogram and statistics and this
    rank's lanes' RNG dims."""
    tracer = build_volume(P, PARALLEL_BATCH, "cpu")
    tracer._debug_rng = True
    fn = P.parallel.shard_trace(tracer, mesh)
    streams = P.parallel.sharded_streams(PARALLEL_BATCH, mesh)
    import torch

    with torch.no_grad():
        hist, stats, dims = fn(tracer.params(), tracer.rng.counter_words, streams)
    return dict(hist=hist, stats=stats, dims=dims, streams=streams)


def job_gradient(P, mesh, out_dir: Path):
    """The sharded gradient in the absorption table: a local backward,
    then reduce_gradients."""
    tracer = build_volume(P, GRAD_BATCH, "cpu", callback=False)
    fn = P.parallel.shard_trace(tracer, mesh)
    tbl = absorption_grad(tracer, fn, P.parallel.sharded_streams(GRAD_BATCH, mesh))
    local = tbl.grad.clone()
    P.parallel.reduce_gradients([tbl], mesh)
    return dict(local=local, grad=tbl.grad)


def job_instanced(P, mesh, out_dir: Path):
    """The instanced scene's batch sharded, through its response's result."""
    tracer = build_instanced(P, INSTANCED_BATCH, "cpu")
    fn = P.parallel.shard_trace(tracer, mesh)
    import torch

    p = tracer.params()
    with torch.no_grad():
        state, _ = fn(p, tracer.rng.counter_words, P.parallel.sharded_streams(tracer.capacity, mesh))
    return dict(hist=tracer.response.result(p["response"], state))


def sharded_pipeline(P):
    tracer = build_pipeline_tracer(P, PIPELINE_BATCH, "cpu")
    return P.pipeline.Pipeline(tracer, runner=P.parallel.ShardedRunner(tracer))


def job_pipeline(P, mesh, out_dir: Path):
    """Pipeline(runner=ShardedRunner) run()."""
    hist, _ = sharded_pipeline(P).run()
    return dict(hist=hist)


def job_converge(P, mesh, out_dir: Path):
    """ConvergeHistogramTask under the scheduler, threaded and synchronous."""
    out = {}
    for threaded in (True, False):
        pipe = sharded_pipeline(P)
        task = P.pipeline.ConvergeHistogramTask({}, **CONVERGE)
        P.pipeline.PipelineScheduler(pipe, dispatchThread=threaded).schedule([task])
        key = "threaded" if threaded else "sync"
        out[f"{key}_batches"] = task.totalBatches
        out[f"{key}_result"] = task.result
        out[f"{key}_offset"] = pipe.tracer.rng.offset
    return out


def job_checkpoint(P, mesh, out_dir: Path):
    """A sharded task stopped after 2 batches, saved, and resumed in a
    fresh pipeline and runner, against 4 batches uninterrupted."""

    def batches(pipe, task, n):
        for _ in range(n):
            task.processBatch(pipe.run())

    pl = P.pipeline
    pipe_ref, task_ref = sharded_pipeline(P), pl.ConvergeHistogramTask(maxBatchCount=50)
    batches(pipe_ref, task_ref, 4)
    pipe_a, task_a = sharded_pipeline(P), pl.ConvergeHistogramTask(maxBatchCount=50)
    batches(pipe_a, task_a, 2)
    ckpt = out_dir / f"sharded-{mesh.rank}.npz"
    pl.saveCheckpoint(ckpt, pipe_a, task_a)
    pipe_b, task_b = sharded_pipeline(P), pl.ConvergeHistogramTask(maxBatchCount=50)
    pl.loadCheckpoint(ckpt, pipe_b, task_b)
    resumed_offset = pipe_b.tracer.rng.offset
    batches(pipe_b, task_b, 2)
    return dict(
        ref_result=task_ref.result, ref_batches=task_ref.totalBatches, ref_offset=pipe_ref.tracer.rng.offset,
        result=task_b.result, batches=task_b.totalBatches, offset=pipe_b.tracer.rng.offset,
        saved_offset=pipe_a.tracer.rng.offset, resumed_offset=resumed_offset,
    )


JOBS = {
    "volume": job_volume,
    "gradient": job_gradient,
    "instanced": job_instanced,
    "pipeline": job_pipeline,
    "converge": job_converge,
    "checkpoint": job_checkpoint,
}


def main(argv) -> int:
    url, world, rank, out_dir, jobs = argv[1], int(argv[2]), int(argv[3]), Path(argv[4]), argv[5].split(",")
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    import theia_tpu_torch as P
    import theia_tpu_torch.parallel  # noqa: F401

    P.parallel.initialize(url, world, rank, backend="gloo")
    try:
        mesh = P.parallel.make_photon_mesh(["cpu"])
        assert (mesh.rank, mesh.size) == (rank, world), mesh
        for job in jobs:
            torch.save(JOBS[job](P, mesh, out_dir), out_dir / f"{job}-{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0


def start_world(out_dir: Path, world: int, jobs) -> list:
    """Start ``world`` worker processes running ``jobs`` (names of
    :data:`JOBS`) in a gloo group initialized through a file in
    ``out_dir``; returns the processes (see :func:`join_world`)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    url = f"file://{out_dir / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), url, str(world), str(rank), str(out_dir), ",".join(jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT),
        )
        for rank in range(world)
    ]


def join_world(procs, out_dir: Path, jobs, timeout: float = WORLD_TIMEOUT) -> dict:
    """Wait for the ranks of :func:`start_world` (killing every one past
    ``timeout`` seconds) and return ``{job: [rank 0's result, ...]}``;
    raises with the ranks' output if any exited with another code than 0."""
    import torch

    deadline = time.monotonic() + timeout
    outputs, codes = [], []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, _ = proc.communicate()
        outputs.append(out)
        codes.append(proc.returncode)
    if any(codes):
        raise RuntimeError(
            f"gloo world failed, exit codes {codes}:\n"
            + "\n".join(f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outputs))
        )
    return {job: [torch.load(out_dir / f"{job}-{r}.pt", weights_only=False) for r in range(len(procs))]
            for job in jobs}


if __name__ == "__main__":
    sys.exit(main(sys.argv))
