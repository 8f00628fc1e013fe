"""Detector array: a grid of instanced modules traced with the two-level
instanced walk, on theia_tpu_torch (examples/08_detector_array.py of
theia_tpu, ported).

The domain's production scenario: many copies of one detector-module
mesh stamped across a lattice (here 3x3x3 BK7-shelled spheres in
scattering water) with a flash in the middle. ``accel="auto"`` picks the
two-level instanced traversal: each lane takes the module boxes its
segment enters, nearest first, and scans only those modules' shared
prototype mesh. The modules are icospheres of 1280 triangles built here,
where theia_tpu's example loads ``sphere.stl``.

Per-module light curves come from the stamped detector ids: the
``HitRecorder`` keeps (detector id, time, contribution) per hit, so one
trace yields every module's transient.

Run: python theia_tpu_torch/examples/08_detector_array.py [--device cpu] [--batch N]
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
from theia_tpu_torch.render import SceneTemplate
from theia_tpu_torch.response import HitRecorder
from theia_tpu_torch.scene import MeshStore, Transform
from theia_tpu_torch.trace import SceneForwardTracer
from sphere_mesh import unit_sphere


class Water(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self):
        WaterBaseModel.__init__(self, 10.0 * u.m, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def main(device="cuda", batch: int = 64 * 1024, check: bool = True) -> int:
    """Traces one batch; returns how many modules recorded light. With
    ``check`` (the script's run) at least half of them must, as in
    theia_tpu's example; a short run at a small batch leaves it out."""
    water = Water().createMedium(num_lambda=64, num_theta=64)
    glass = BK7Model().createMedium(num_lambda=64, num_theta=4)
    # photons arrive from the water; detect and absorb at the shell
    mats = MaterialStore.pack([Material("det_shell", glass, water, flags="DB")], device=device)

    meshes = MeshStore({"sphere": unit_sphere()})
    proto = meshes.createInstance("sphere", "det_shell", Transform.TRS(scale=0.35 * u.m))
    template = SceneTemplate([proto])

    n_side, spacing = 3, 2.0 * u.m
    transforms = [
        Transform.TRS(translate=((i - 1) * spacing, (j - 1) * spacing, (k - 1) * spacing))
        for i in range(n_side)
        for j in range(n_side)
        for k in range(n_side)
        if not (i == j == k == 1)  # keep the center free for the flash
    ]
    scene = template.createScene(transforms, mats, medium="water", device=device)
    print(f"accel backend picked by auto: {scene.accel}")

    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        UniformWavelengthSource(lambdaRange=(400.0 * u.nm, 500.0 * u.nm)),
        HitRecorder(),
        PhiloxRNG(key=0xA11CE),
        scene,
        maxPathLength=8,
        maxTime=120.0 * u.ns,
        device=device,
    )

    hits, _ = tracer.run()
    valid = hits["valid"]
    det = hits["objectId"][valid].long()
    t = hits["time"][valid]
    contrib = hits["contrib"][valid]

    n_det = len(transforms)
    totals = torch.zeros(n_det, dtype=torch.float64, device=det.device).index_add_(0, det, contrib.double())
    first = torch.full((n_det,), torch.inf, device=det.device).scatter_reduce(0, det, t, "amin")

    # the 6 face-adjacent modules sit nearest the flash: earliest light
    order = torch.argsort(first)
    lit = int(torch.count_nonzero(totals))
    print(f"{int(valid.sum())} hits across {lit} modules")
    for d in order[:6].tolist():
        print(f"  module {d:2d}: first light {float(first[d]):6.2f} ns, total {float(totals[d]):.3e} photons")
    if check:
        assert lit >= n_det // 2, lit
    print("per-module light curves recorded")
    return lit


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=64 * 1024)
    main(**vars(args.parse_args()))
