"""theia_tpu_torch must run without jax: importing every module and
tracing a small batch of each backend's flagship, the volume flagship,
the volume photon tracer (run and run_compacted) and the photon flagship,
and taking a gradient step through the table reads and the kernel
histogram (the volume tracer in its group velocity, the brute-force
scene in its detector's position), in a fresh interpreter leaves jax and
theia_tpu unloaded; the port's example scripts import neither."""

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
import dataclasses, importlib.util, pathlib, torch
for script in sorted(pathlib.Path(theia_tpu_torch.__file__).parent.joinpath("examples").glob("*.py")):
    spec = importlib.util.spec_from_file_location("example_" + script.stem[:2], script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from torch_flagship import build_flagship, build_photon_flagship, build_volume_flagship, icosphere
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
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "theia_tpu"))
print("LOADED", loaded)
"""


def test_port_never_imports_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
