"""Detector-geometry calibration: recover a misplaced module's position
from calibration-flash data by gradient descent through the simulator,
on theia_tpu_torch (examples/10_geometry_calibration.py of theia_tpu,
ported).

Flashes at known positions illuminate a string of three modules, one of
which is off its nominal position. "Observed" per-module transients are
simulated with the true (offset) geometry, then the offset is fitted by
minimizing the curve mismatch with gradients through the whole Monte
Carlo simulation. Geometry enters through
``ScenePack.translate_instance(id, delta)`` on the brute-force scene, an
ordinary differentiable function of ``delta``; the modules are
icospheres of 1280 triangles built here, where theia_tpu's example loads
``sphere.stl``.

Run: python theia_tpu_torch/examples/10_geometry_calibration.py [--device cpu] [--batch N]
(the card by default).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np
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

# module 0 is actually displaced by this much from its nominal position.
# The reparameterized gradient captures how existing hit lanes' arrival
# times and transmittances move, but not lanes entering/leaving the
# detector (the visibility-boundary term of differentiable rendering),
# so calibration is accurate for offsets small against the module radius
TRUE_OFFSET = (0.12, -0.08, 0.05)


def main(device="cuda", batch: int = 8 * 1024, iterations: int = 30, check: bool = True) -> float:
    """Calibrates module 0's offset; returns the error in metres. With
    ``check`` (the script's run) the error must be under 6 cm, as in
    theia_tpu's example; a short run at a small batch leaves it out."""
    medium = WaterTestModel(mu_a=0.01, mu_s=0.04, g=0.5).createMedium()
    mats = MaterialStore.pack([Material("det", None, medium, flags="DB")], device=device)
    meshes = MeshStore({"sphere": unit_sphere()})
    # a small string of 3 modules; module 0 is the suspect
    insts = [
        meshes.createInstance(
            "sphere", "det", Transform.TRS(scale=0.4, translate=(0.0, 0.0, 2.0 * k - 2.0)), detectorId=k
        )
        for k in range(3)
    ]
    scene = Scene(insts, mats, medium="water_test", accel="brute", device=device)

    # calibration flashes at known positions bracket the string
    flashes = [(-2.5, 0.0, -1.0), (2.0, 2.0, 0.0), (0.5, -2.2, 1.5)]
    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(position=flashes[0], timeRange=(0.0, 0.0), budget=1e6),
        UniformWavelengthSource(lambdaRange=(420.0, 480.0)),
        KernelHistogramHitResponse(nBins=40, t0=0.0, binSize=1.0 * u.ns, nDetectors=3),
        PhiloxRNG(key=0xCAB),
        scene,
        maxPathLength=4,
        maxTime=40.0 * u.ns,
        device=device,
    )
    fn, (p0, counter, streams) = tracer.trace_fn()
    dev = tracer.device
    true_offset = torch.tensor(TRUE_OFFSET, device=dev)

    def curves(offset, flash):
        p = {**p0, "scene": p0["scene"].translate_instance(0, offset)}
        p["lightSource"] = {**p0["lightSource"], "position": torch.tensor(flash, device=dev)}
        resp, _ = fn(p, counter, streams)
        return tracer.response.result(p["response"], resp)

    with torch.no_grad():
        observed = [curves(true_offset, f) for f in flashes]

    def value_and_grad(offset):
        offset = offset.clone().requires_grad_(True)
        loss = sum(((curves(offset, f) - obs) ** 2).sum() / (obs**2).sum() for f, obs in zip(flashes, observed))
        loss.backward()
        return loss.item(), offset.grad

    offset = torch.zeros(3, device=dev)  # start at nominal
    print(f"start {offset.cpu().numpy().round(3)}  (true {np.asarray(TRUE_OFFSET)})")
    # fixed RNG streams make the loss deterministic; Adam handles the
    # anisotropic curvature (x is far better constrained than y here)
    m, vv = torch.zeros(3, device=dev), torch.zeros(3, device=dev)
    lr, b1, b2 = 0.03, 0.9, 0.999
    for it in range(iterations):
        v, g = value_and_grad(offset)
        m = b1 * m + (1 - b1) * g
        vv = b2 * vv + (1 - b2) * g * g
        mh = m / (1 - b1 ** (it + 1))
        vh = vv / (1 - b2 ** (it + 1))
        offset = offset - lr * mh / (torch.sqrt(vh) + 1e-9)
        if it % 6 == 0:
            print(f"  it {it:2d}: loss {v:.4f} offset {offset.cpu().numpy().round(3)}")

    err = float(torch.linalg.norm(offset - true_offset))
    print(f"calibrated offset {offset.cpu().numpy().round(3)}, error {err * 100:.1f} cm")
    if check:
        assert err < 0.06, err
        print("module position calibrated by gradient descent")
    return err


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=8 * 1024)
    main(**vars(args.parse_args()))
