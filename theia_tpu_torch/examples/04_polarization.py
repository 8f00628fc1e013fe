"""Polarized transport: Brewster's angle on a water/glass interface, on
theia_tpu_torch (examples/04_polarization.py of theia_tpu, ported).

A pencil beam that reflects off a glass wall at Brewster's angle vanishes
for p-polarized light and follows the Fresnel coefficients otherwise (the
Stokes-vector forward transport; the reference's docs/polarization.md).

Run: python theia_tpu_torch/examples/04_polarization.py [--device cpu]
(the card by default).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from theia_tpu_torch.light import PencilLightSource, UniformWavelengthSource
from theia_tpu_torch.material import DispersionFreeMedium, Material, MaterialStore
from theia_tpu_torch.mesh import Mesh
from theia_tpu_torch.random import PhiloxRNG
from theia_tpu_torch.response import HitRecorder
from theia_tpu_torch.scene import MeshStore, Scene, Transform
from theia_tpu_torch.trace import SceneForwardTracer

N_WATER, N_GLASS = 4.0 / 3.0, 1.5
LANES = 256


def plane(z, size, flip=False):
    pos = [(-size, -size, z), (size, -size, z), (size, size, z), (-size, size, z)]
    faces = [(0, 1, 2), (0, 2, 3)] if not flip else [(0, 2, 1), (0, 3, 2)]
    return Mesh.from_geometry(pos, faces)


def detected(stokes_q: float, device) -> float:
    """The reflected share of a beam with Stokes Q = ``stokes_q``."""
    water = DispersionFreeMedium(n=N_WATER, ng=N_WATER, mu_a=0.0, mu_s=0.0).createMedium(name="water")
    glass = DispersionFreeMedium(n=N_GLASS, ng=N_GLASS, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    store = MaterialStore.pack(
        [Material("mirror", glass, "water", flags="R"), Material("det", None, "water", flags="DB")],
        media=[water],
        device=device,
    )
    meshes = MeshStore({"wall": plane(0.0, 50.0), "lid": plane(0.0, 50.0, flip=True)})
    scene = Scene(
        [
            meshes.createInstance("wall", "mirror"),
            meshes.createInstance("lid", "det", Transform.Translation(0, 0, 2.0), detectorId=1),
        ],
        store,
        medium="water",
        device=device,
    )
    theta = np.arctan2(N_GLASS, N_WATER)  # Brewster from the water side
    tracer = SceneForwardTracer(
        LANES,
        PencilLightSource(
            position=(-2.0 * np.tan(theta), 5.0, 2.0),
            direction=(np.sin(theta), 0.0, -np.cos(theta)),
            timeRange=(0.0, 0.0),
            budget=1.0,
            stokes=(1.0, stokes_q, 0.0, 0.0),
            polarizationRef=(0.0, -1.0, 0.0),  # perpendicular to the plane of incidence
        ),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HitRecorder(polarized=True),
        PhiloxRNG(key=0xB0),
        scene,
        maxPathLength=4,
        scatterCoefficient=1e-6,
        maxTime=1000.0,
        targetId=1,
        polarized=True,
        device=device,
    )
    hits, _ = tracer.run()
    valid = hits["valid"]
    return float(hits["contrib"][valid].sum()) / LANES


def main(device="cuda") -> float:
    """Prints the three reflected shares; returns the s-polarized one's
    distance from r_s^2."""
    theta = np.arctan2(N_GLASS, N_WATER)
    sin_t = np.sin(theta) * N_WATER / N_GLASS
    cos_t = np.sqrt(1 - sin_t**2)
    r_s = (N_WATER * np.cos(theta) - N_GLASS * cos_t) / (N_WATER * np.cos(theta) + N_GLASS * cos_t)
    s_share = detected(-1.0, device)
    print(f"Brewster angle (water->glass): {np.rad2deg(theta):.2f} deg")
    print(f"p-polarized reflected: {detected(+1.0, device):.3e}  (analytic: 0)")
    print(f"s-polarized reflected: {s_share:.6f}  (analytic r_s^2 = {r_s**2:.6f})")
    print(f"unpolarized reflected: {detected(0.0, device):.6f}  (analytic R = {0.5 * r_s**2:.6f})")
    return abs(s_share - r_s**2)


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    main(**vars(args.parse_args()))
