"""Source reconstruction: locate a light flash inside a detector array
from its per-module transients by gradient descent through the
simulator, on theia_tpu_torch (examples/09_source_reconstruction.py of
theia_tpu, ported).

Eight modules surround an unknown flash. The "observed" per-module
kernel-histogram light curves come from the true position; the flash
position is then fitted by descending the normalized curve mismatch,
with the gradient through ``trace_fn()`` (hit distances reattached to
the geometry, arrival times through the kernel histogram). The array
takes the two-level instanced walk (``accel="instanced"``); its selection
runs without gradients and the winners' reconstruction carries them. The
modules are icospheres of 1280 triangles built here, where theia_tpu's
example loads ``sphere.stl``.

Run: python theia_tpu_torch/examples/09_source_reconstruction.py [--device cpu] [--batch N]
(the card by default).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch

import theia_tpu_torch.units as u
from theia_tpu_torch.light import SphericalLightSource, UniformWavelengthSource
from theia_tpu_torch.material import Material, MaterialStore
from theia_tpu_torch.random import PhiloxRNG
from theia_tpu_torch.response import KernelHistogramHitResponse
from theia_tpu_torch.scene import MeshStore, Scene, Transform
from theia_tpu_torch.testing import WaterTestModel
from theia_tpu_torch.trace import SceneForwardTracer
from sphere_mesh import unit_sphere

TRUE_POS = (0.3, -0.2, 0.1)


def main(device="cuda", batch: int = 8 * 1024, iterations: int = 12, check: bool = True) -> float:
    """Fits the flash position; returns its error in metres. With
    ``check`` (the script's run) it must be under 12 cm, as in
    theia_tpu's example; a short run at a small batch leaves it out."""
    medium = WaterTestModel(mu_a=0.01, mu_s=0.05, g=0.6).createMedium()
    mats = MaterialStore.pack([Material("det", None, medium, flags="DB")], device=device)
    meshes = MeshStore({"sphere": unit_sphere()})
    insts = [
        meshes.createInstance(
            "sphere", "det", Transform.TRS(scale=0.4, translate=(2.0 * i - 1, 2.0 * j - 1, 2.0 * k - 1)),
            detectorId=(i * 2 + j) * 2 + k,
        )
        for i in range(2)
        for j in range(2)
        for k in range(2)
    ]
    scene = Scene(insts, mats, medium="water_test", accel="instanced", device=device)

    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        UniformWavelengthSource(lambdaRange=(420.0, 480.0)),
        KernelHistogramHitResponse(nBins=40, t0=0.0, binSize=1.0 * u.ns, nDetectors=8),
        PhiloxRNG(key=0xBADA55),
        scene,
        maxPathLength=5,
        maxTime=40.0 * u.ns,
        device=device,
    )
    fn, (p0, counter, streams) = tracer.trace_fn()
    dev = tracer.device

    def curves(pos):
        """Normalized per-module light curves (8 modules, 40 bins),
        differentiable in pos."""
        p = {**p0, "lightSource": {**p0["lightSource"], "position": pos}}
        resp, _ = fn(p, counter, streams)
        return tracer.response.result(p["response"], resp)

    true_pos = torch.tensor(TRUE_POS, device=dev)
    with torch.no_grad():
        observed = curves(true_pos)  # "data" taken at the unknown true position

    def value_and_grad(pos):
        pos = pos.clone().requires_grad_(True)
        c = curves(pos)
        loss = ((c - observed) ** 2).sum() / (observed**2).sum()
        loss.backward()
        return loss.item(), pos.grad

    pos = torch.zeros(3, device=dev)  # start at the array center
    print(f"start {pos.cpu().numpy().round(3)}  (true {true_pos.cpu().numpy()})")
    for it in range(iterations):
        v, g = value_and_grad(pos)
        pos = pos - 0.05 * g / torch.clamp_min(torch.linalg.vector_norm(g), 1e-9)
        if it % 5 == 0:
            print(f"  it {it:2d}: loss {v:.4f} pos {pos.cpu().numpy().round(3)}")

    err = float(torch.linalg.vector_norm(pos - true_pos))
    print(f"reconstructed {pos.cpu().numpy().round(3)}, error {err * 100:.1f} cm")
    if check:
        assert err < 0.12, err
        print("flash position recovered by gradient descent")
    return err


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=8 * 1024)
    main(**vars(args.parse_args()))
