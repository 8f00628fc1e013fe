"""Debug rendering: an orthographic normal-shaded view of a scene, on
theia_tpu_torch (examples/07_scene_render.py of theia_tpu, ported).

Mirrors the reference's SceneRender debug renderer (scene.render.glsl):
useful for checking instance transforms, normals and detector placement
before spending compute on a simulation. theia_tpu's example loads
``sphere.stl`` and ``suzanne.stl`` from the reference's assets; this one
builds an icosphere and, in suzanne's place, a torus in code, writes both
as binary STL files and loads the scene's meshes from those files through
``MeshStore``. The image is written as a PPM, so it needs no imaging
package; each pixel's ray goes through the scene's nearest-hit query on
the device.

Run: python theia_tpu_torch/examples/07_scene_render.py [--device cpu] [--out scene.ppm]
(the card by default; the meshes and the image go to a temporary folder
unless --out names the image).
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from sphere_mesh import torus, unit_sphere, write_stl
from theia_tpu_torch.material import Material, MaterialStore
from theia_tpu_torch.render import SceneRender
from theia_tpu_torch.scene import MeshStore, Scene, Transform
from theia_tpu_torch.testing import WaterTestModel


def main(device="cuda", width: int = 320, height: int = 240, out=None) -> float:
    """Renders the scene; returns the share of pixels that hit geometry."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_stl(tmp / "sphere.stl", unit_sphere(3))
        write_stl(tmp / "torus.stl", torus())
        medium = WaterTestModel().createMedium()
        store = MaterialStore.pack([Material("m", medium, None, flags="DB")], device=device)
        meshes = MeshStore({"sphere": tmp / "sphere.stl", "torus": tmp / "torus.stl"})
        scene = Scene(
            [
                meshes.createInstance("torus", "m", Transform.TRS(scale=1.0)),
                meshes.createInstance("sphere", "m", Transform.TRS(scale=0.4, translate=(1.6, 0.0, 0.6))),
            ],
            store,
            medium="water_test",
            device=device,
        )
        img = SceneRender(
            width=width,
            height=height,
            dimension=(4.0, 3.0),
            position=(0.0, -5.0, 0.0),
            direction=(0.0, 1.0, 0.0),
            up=(0.0, 0.0, 1.0),
            maxDistance=20.0,
        ).render(scene)
        rgb = np.asarray(img)[..., :3]
        path = Path(out) if out is not None else tmp / "scene.ppm"
        with path.open("wb") as f:
            f.write(f"P6\n{width} {height}\n255\n".encode())
            f.write(rgb.astype(np.uint8).tobytes())
        hit_frac = float((rgb.sum(-1) < 3 * 255).mean())  # the background renders white
        print(f"rendered {width} x {height} pixels ({path.name}): {hit_frac * 100:.1f}% of pixels hit geometry")
    return hit_frac


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--out", default=None)
    main(**vars(args.parse_args()))
