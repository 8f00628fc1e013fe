"""theia_tpu_torch must run without jax: importing every module and
tracing a small batch of each backend's flagship (the BVH and the
instanced walk too, the BVH's builder compiled from the port's own copy), the volume flagship,
the volume photon tracer (run and run_compacted) and the photon flagship,
taking a gradient step through the table reads and the kernel
histogram (the volume tracer in its group velocity, the brute-force
scene in its detector's position), and tracing the brute-force flagship
with a SobolQRNG, a polarized VolumeBackwardTracer and a DirectLightTracer
on a scene, the two scene backward tracers and the polarized
bidirectional tracer, the volume flagship from a TargetLightSource, the Cherenkov runs (a muon
and a cascade forward, a cascade and a track backward), the flagship
guided by a disk and the value queue with its estimator, then the last
single-card modules (a two-batch threaded PipelineScheduler with a
ConvergeHistogramTask, a checkpoint, a SceneRender of a scene loaded
from an STL file, a material archive written and read back, the 2-D
tables and the samplers), and the last slice (the multi-device layer in
a world of one process, ``ShardedRunner`` under a pipeline,
``profiling.profile_batch`` and a binned MT query), in a fresh interpreter
leaves jax, theia_tpu and jsonschema unloaded; the port's example scripts
import none of them."""

import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent

SCRIPT = f"""
import sys
sys.path.insert(0, {str(TESTS)!r})
sys.path.insert(0, {str(TESTS.parent)!r})
import theia_tpu_torch
import theia_tpu_torch.ops.intersect_woop
import theia_tpu_torch.ops.intersect_soup
import theia_tpu_torch.polarization
import theia_tpu_torch.callback, theia_tpu_torch.interop, theia_tpu_torch.light, theia_tpu_torch.lookup
import theia_tpu_torch.target, theia_tpu_torch.response, theia_tpu_torch.material
import theia_tpu_torch.trace.volume, theia_tpu_torch.trace.photon
import theia_tpu_torch.testing, theia_tpu_torch.ops.table_read
import theia_tpu_torch.native, theia_tpu_torch.ops.bvh_traverse, theia_tpu_torch.ops.instanced
import theia_tpu_torch.render
import theia_tpu_torch.camera, theia_tpu_torch.trace.backward, theia_tpu_torch.trace.direct
import dataclasses, importlib.util, pathlib, torch
for script in sorted(pathlib.Path(theia_tpu_torch.__file__).parent.joinpath("examples").glob("*.py")):
    spec = importlib.util.spec_from_file_location("example_" + script.stem[:2], script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from torch_flagship import build_array, build_flagship, build_photon_flagship, build_volume_flagship, icosphere
for accel in ("bvh", "instanced"):
    hist, _ = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel=accel, device="cpu").run()
    assert hist.shape == (100,)
array = build_array(theia_tpu_torch, icosphere(2), 64, 2, device="cpu")
assert array.scene.accel == "instanced" and array.run()[0]["valid"].shape == (128,)
for pol in (False, True):
    hist, _ = build_volume_flagship(theia_tpu_torch, 64, "cpu", polarized=pol).run()
    assert hist.shape == (100,)
P = theia_tpu_torch
photons = P.trace.VolumePhotonTracer(
    64, P.light.SphericalLightSource(), P.target.InnerSphereTarget(radius=50.0),
    P.light.ConstWavelengthSource(450.0), P.response.HistogramHitResponse(nBins=10, binSize=50.0),
    P.random.PhiloxRNG(key=1), medium=P.material.DispersionFreeMedium(mu_a=0.05, mu_s=0.02).createMedium(),
    nScatteringPerRun=2, nRuns=2, device="cpu",
)
assert photons.run()[0].shape == photons.run_compacted(min_lanes=8).shape == (10,)
hist, _ = build_photon_flagship(theia_tpu_torch, icosphere(1), 64, "cpu").run()
assert hist.shape == (50,)
tracer = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, device="cpu")
hist, _ = tracer.run()
assert hist.shape == (100,)
tracer = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="woop", device="cpu", polarized=True)
hist, _ = tracer.run()
assert hist.shape == (100,)
tracer = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="auto", device="cpu")
assert tracer.scene.accel == "brute" and tracer.scene.pack.cull is not None
hist, _ = tracer.run()
assert hist.shape == (100,)
P = theia_tpu_torch
kde = P.response.KernelHistogramHitResponse(nBins=100, binSize=5.0, bandwidth=5.0)
vol = build_volume_flagship(P, 64, "cpu", response=kde, medium=P.testing.WaterTestModel().createMedium())
fn, (p, counter, streams) = vol.trace_fn()
vg = p["medium"].group_velocity.clone().requires_grad_(True)
fn(dict(p, medium=dataclasses.replace(p["medium"], group_velocity=vg)), counter, streams)[0].sum().backward()
assert vg.grad is not None
kde = P.response.KernelHistogramHitResponse(nBins=100, binSize=5.0, bandwidth=5.0)
tracer = build_flagship(P, icosphere(1), 64, 2, accel="auto", device="cpu", response=kde)
fn, (p, counter, streams) = tracer.trace_fn()
shift = torch.zeros(3, requires_grad=True)
fn(dict(p, scene=p["scene"].translate_instance(2, shift)), counter, streams)[0].sum().backward()
assert shift.grad is not None
sobol = lambda rnd: rnd.SobolQRNG(seed=42, dims=128)
hist, _ = build_flagship(P, icosphere(1), 64, 2, accel="auto", device="cpu", rng=sobol).run()
assert hist.shape == (100,)
cam = P.camera.SphereCamera(position=(5.0, 0.0, 0.0), radius=1.0)
light, lam = P.light.SphericalLightSource(timeRange=(0.0, 0.0)), P.light.ConstWavelengthSource(450.0)
back = P.trace.VolumeBackwardTracer(
    64, light, cam, lam, P.response.HistogramHitResponse(nBins=10, binSize=20.0), P.random.SobolQRNG(dims=16),
    medium=P.testing.WaterTestModel().createMedium(), nScattering=3, polarized=True, device="cpu",
)
assert back.run()[0].shape == (10,)
direct = P.trace.DirectLightTracer(
    64, light, cam, lam, P.response.HistogramHitResponse(nBins=10, binSize=20.0), P.random.PhiloxRNG(key=3),
    build_flagship(P, icosphere(1), 1, 2, accel="auto", device="cpu").scene, device="cpu",
)
assert direct.run()[0].shape == (10,)
import theia_tpu_torch.trace.scene_backward, theia_tpu_torch.trace.bidirectional
from torch_flagship import build_bidirectional, build_lamp, build_scene_backward, build_scene_backward_target
assert build_scene_backward_target(P, 64, "cpu", mesh=icosphere(1)).run()[0]["valid"].any()
assert build_lamp(P, 64, "cpu", mesh=icosphere(1), detector=True).run()[0].shape == (50,)
back = build_scene_backward(
    P, 64, "cpu", mesh=icosphere(1), max_path=3, polarized=True, response=P.response.HistogramHitResponse(nBins=10, binSize=100.0),
)
assert back.run()[0].shape == (10,)
assert build_bidirectional(P, 64, "cpu", mesh=icosphere(1), path=2, polarized=True).run()[0].shape == (60,)
focused = P.light.TargetLightSource(P.light.SphericalLightSource(), P.light.FlatLightSourceTarget(position=(0.0, -3.0, 0.0)))
assert build_volume_flagship(P, 64, "cpu", source=focused).run()[0].shape == (100,)
import theia_tpu_torch.cascades, theia_tpu_torch.items, theia_tpu_torch.ops.gamma, theia_tpu_torch.ops.cherenkov_track
from torch_flagship import build_cherenkov_backward, build_cherenkov_volume, cascade_source, track_line_source
for kind in ("muon", "cascade"):
    assert build_cherenkov_volume(P, 64, "cpu", source=kind, nScattering=2).run()[0].shape == (100,)
for source in (cascade_source(P), track_line_source(P, "track", 8)):
    assert build_cherenkov_backward(P, 64, "cpu", source=source, nScattering=2).run()[0].shape == (60,)
assert build_flagship(P, icosphere(1), 64, 2, accel="auto", device="cpu", guide="disk").run()[0].shape == (100,)
queue, _ = build_volume_flagship(P, 64, "cpu", response=P.response.StoreValueHitResponse()).run()
assert P.response.HistogramEstimator(nBins=10, binSize=50.0)(queue).shape == (10,)
assert P.items.ValueItem.from_queue(queue).dtype.itemsize == 8
import tempfile
import theia_tpu_torch.pipeline, theia_tpu_torch.task, theia_tpu_torch.testing, theia_tpu_torch.mesh
from torch_flagship import build_example03, write_stl
flash, beam = build_example03(P, 64, 2, "cpu")
seen = []
task = P.pipeline.ConvergeHistogramTask(initialBatchCount=2, maxBatchCount=2)
sched = P.pipeline.PipelineScheduler([("flash", P.pipeline.Pipeline(flash)), ("beam", P.pipeline.Pipeline(beam))],
                                     processFn=lambda c, b, r: seen.append(r[0].shape))
sched.schedule([("flash", task), ("beam", {{}})])
assert set(seen) == {{(100,)}} and len(seen) == task.totalBatches + 1 >= 3
with tempfile.TemporaryDirectory() as tmp:
    P.pipeline.saveCheckpoint(tmp + "/c.npz", sched.pipelines["flash"], task)
    write_stl(tmp + "/s.stl", icosphere(1))
    scene = build_flagship(P, tmp + "/s.stl", 1, 2, accel="auto", device="cpu").scene
    img = P.render.SceneRender(width=16, height=16, dimension=(6.0, 6.0), position=(1.5, -6.0, 0.0)).render(scene)
    assert img.shape == (16, 16, 4) and (img[..., :3] < 255).any()
    water = P.testing.WaterTestModel().createMedium(num_lambda=8, num_theta=8)
    P.material.saveMaterials(tmp + "/m.zip", [P.material.Material("m", water, None)])
    assert "water_test" in P.material.loadMaterials(tmp + "/m.zip")[1]
assert P.lookup.lookup2d(torch.ones(3, 4), torch.rand(8), torch.rand(8)).shape == (8,)
assert P.testing.sampleLight(P.light.SphericalLightSource(), 8, device="cpu").position.shape == (8, 3)
import theia_tpu_torch.parallel, theia_tpu_torch.profiling, theia_tpu_torch.ops._intersect_tiles
mesh = P.parallel.make_photon_mesh(["cpu"])
vol = build_volume_flagship(P, 64, "cpu")
hist, _ = P.parallel.shard_trace(vol, mesh)(vol.params(), vol.rng.counter_words, P.parallel.sharded_streams(64, mesh))
assert hist.shape == (100,)
assert P.pipeline.Pipeline(vol, runner=P.parallel.ShardedRunner(vol)).run()[0].shape == (100,)
with tempfile.TemporaryDirectory() as tmp:
    assert P.profiling.profile_batch(vol, tmp, runs=1)["min"] > 0
mt = build_flagship(P, icosphere(1), 64, 2, accel="mt", device="cpu").scene.pack.mt
o, d = torch.rand(64, 3), torch.nn.functional.normalize(torch.randn(64, 3), dim=1)
assert torch.equal(P.ops.intersect_mt.nearest_triangle_mt(mt, o, d, 5.0, binned=True)[1],
                   P.ops.intersect_mt.nearest_triangle_mt(mt, o, d, 5.0, binned=False)[1])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "theia_tpu", "jsonschema"))
print("LOADED", loaded)
"""


def test_port_never_imports_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
