"""Scene tracing: a glass-shelled lamp illuminating a detector sphere, on
theia_tpu_torch (examples/02_scene_tracing.py of theia_tpu, ported).

A light source inside an air-filled BK7 glass shell, a black detector
sphere nearby, both submerged in scattering water. Fresnel transmission
and reflection at every interface; target-guide MIS speeds convergence.
The scene takes the threaded-BVH backend (``accel="bvh"``, built by the
package's native builder); the spheres are icospheres of 1280 triangles
built here, where theia_tpu's example loads ``sphere.stl``.

Run: python theia_tpu_torch/examples/02_scene_tracing.py [--device cpu] [--batch N]
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
from theia_tpu_torch.material import (
    BK7Model,
    HenyeyGreensteinPhaseFunction,
    Material,
    MaterialStore,
    MediumModel,
    WaterBaseModel,
)
from theia_tpu_torch.random import PhiloxRNG
from theia_tpu_torch.response import HistogramHitResponse
from theia_tpu_torch.scene import MeshStore, Scene, Transform
from theia_tpu_torch.target import SphereTargetGuide
from theia_tpu_torch.trace import SceneForwardTracer
from sphere_mesh import unit_sphere


class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def main(device="cuda", batch: int = 64 * 1024, runs: int = 4) -> float:
    """Traces ``runs`` batches; returns the mean light curve's total."""
    water = WaterModel().createMedium(num_lambda=256, num_theta=256)
    glass = BK7Model().createMedium(num_lambda=256, num_theta=4)
    mats = MaterialStore.pack(
        [
            # outer shell surface: glass inside, water outside
            Material("glass_water", glass, water, flags="TR"),
            # inner shell surface: air (vacuum) inside, glass outside
            Material("air_glass", None, glass, flags="TR"),
            # detector: black body, detectable
            Material("det_water", None, water, flags="DB"),
        ],
        device=device,
    )
    meshes = MeshStore({"sphere": unit_sphere()})
    light_pos, det_pos = (3.0, 0.0, 0.0), (0.0, 3.0, 0.0)
    scene = Scene(
        [
            meshes.createInstance("sphere", "glass_water", Transform.TRS(scale=0.8, translate=light_pos)),
            meshes.createInstance("sphere", "air_glass", Transform.TRS(scale=0.75, translate=light_pos)),
            meshes.createInstance(
                "sphere", "det_water", Transform.TRS(scale=0.6, translate=det_pos), detectorId=1
            ),
        ],
        mats,
        medium="water",
        accel="bvh",  # the threaded BVH; "brute" for tiny scenes
        device=device,
    )
    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(position=light_pos, timeRange=(0.0, 10.0), budget=1e5),
        UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=42),
        scene,
        maxPathLength=8,
        sourceMedium="vacuum",  # source sits in the air-filled shell
        scatterCoefficient=0.05,
        targetId=1,
        targetGuide=SphereTargetGuide(position=det_pos, radius=0.6),
        device=device,
    )
    hist = sum(tracer.run()[0] for _ in range(runs)) / runs
    peak = int(torch.argmax(hist))
    print(f"detector light curve: total={float(hist.sum()):.4g}, "
          f"peak at {peak * 5.0:.0f} ns, first 10 bins: {hist[:10].cpu().numpy().round(2)}")
    return float(hist.sum())


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=64 * 1024)
    main(**vars(args.parse_args()))
