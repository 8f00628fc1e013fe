"""theia_tpu_torch.render.SceneRender against theia_tpu's at 64 x 64 on
the flagship scene (two BK7 shells and the detector sphere), on the
default brute-force pack, on ``accel="mt"`` and on the instanced array.

Tolerance: the pixels' rays are made on the host in float64 by the same
code; the hits go through each package's nearest-hit query, whose t
agrees to ulps (JAX divides, the port takes a reciprocal and a Newton
step, tests/test_torch_brute.py), and the shading is 0.5 * (normal + 1)
truncated to 8 bits. So pixels may differ only where a grazing ray hits
in one package and misses in the other, or a channel sits on a level's
edge: allowed on at most 0.1 % of the pixels, each within one level
(measured: none)."""

import numpy as np
import pytest
import torch

import theia_tpu
import theia_tpu_torch
from torch_flagship import build_array, build_flagship, icosphere

torch.set_num_threads(1)

VIEW = dict(width=64, height=64, dimension=(5.0, 5.0), position=(1.5, -6.0, 0.5), direction=(0.0, 1.0, 0.0),
            up=(0.0, 0.0, 1.0), maxDistance=20.0)
ARRAY_VIEW = dict(VIEW, dimension=(6.0, 6.0), position=(0.3, -8.0, 0.2))


def compare(ji, ti, min_hit):
    assert ti.shape == ji.shape and ti.dtype == ji.dtype == np.uint8
    assert (ti[..., 3] == 255).all()
    hit = (ji[..., :3].astype(int).sum(-1) < 3 * 255).mean()
    assert hit > min_hit, hit
    diff = np.abs(ji.astype(int) - ti.astype(int)).max(-1)
    assert (diff > 0).mean() <= 1e-3 and diff.max() <= 1, ((diff > 0).mean(), diff.max())


@pytest.mark.parametrize("accel", ["auto", "mt"])
def test_render_flagship_matches_jax(accel):
    j = build_flagship(theia_tpu, icosphere(3), 16, 2, accel=accel).scene
    t = build_flagship(theia_tpu_torch, icosphere(3), 16, 2, accel=accel, device="cpu").scene
    assert t.accel == j.accel == ("brute" if accel == "auto" else "mt")
    compare(theia_tpu.render.SceneRender(**VIEW).render(j), theia_tpu_torch.render.SceneRender(**VIEW).render(t), 0.1)


def test_render_array_matches_jax():
    j = build_array(theia_tpu, icosphere(2), 16, 2).scene
    t = build_array(theia_tpu_torch, icosphere(2), 16, 2, device="cpu").scene
    assert t.accel == "instanced"
    compare(theia_tpu.render.SceneRender(**ARRAY_VIEW).render(j),
            theia_tpu_torch.render.SceneRender(**ARRAY_VIEW).render(t), 0.05)


def test_render_rays_and_background():
    r = theia_tpu_torch.render.SceneRender(width=4, height=3, dimension=(2.0, 1.0), position=(0.0, 0.0, 0.0))
    o, d = r.rays()
    assert o.shape == d.shape == (12, 3) and o.dtype == np.float32
    np.testing.assert_allclose(o[[0, -1]], [[-1.0, 0.0, -0.5], [1.0, 0.0, 0.5]], atol=1e-7)
    empty = build_flagship(theia_tpu_torch, icosphere(1), 16, 2, device="cpu").scene
    img = theia_tpu_torch.render.SceneRender(width=8, height=8, position=(50.0, 0.0, 0.0)).render(empty)
    assert (img == 255).all()  # every ray misses: white
