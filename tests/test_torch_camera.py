"""The port's cameras against ``theia_tpu``'s on the CPU: each case of
``tests/test_camera.py`` (pencil, flat, cone, sphere and point cameras in
ray mode, and flat, cone and sphere in direct mode), plus the mesh camera
(both modes, inward and outward) and the host camera (with and without
polarization frames), on the same parameters and the same Philox streams
in both packages. Every field of every ray and sample is compared, the
polarization frames and Mueller matrices included, and so is the lanes'
RNG dim after the draws.

Tolerances and why: positions and directions within 2e-6 of their scale
(float32 ulps of sin, cos and sqrt, which differ between XLA and torch on
the CPU, and of 3x3 products summed in another order); polarization
frames and Mueller matrices within 1e-5 absolute (the rotation's
coefficients are products of dot and cross products of those vectors;
measured at most 2.3e-6); contributions within rtol 1e-5 (the same ulps
through a product of a few factors) and 1e-6 of the largest: a grazing
connection's cosine is a dot product near 0, whose ulps are large
relative to it. Integer fields and the RNG dims are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from torch_flagship import icosphere

torch.set_num_threads(1)

N = 4096
PACKAGES = (theia_tpu, theia_tpu_torch)


def _unit(v):
    return tuple(np.asarray(v, np.float64) / np.linalg.norm(v))


def _rot(axis, angle):
    axis = np.asarray(_unit(axis))
    c, s = np.cos(angle), np.sin(angle)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + s * k + (1 - c) * (k @ k)


def _host_rays(n, pol):
    rng = np.random.default_rng(4)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = dict(
        position=rng.uniform(-5, 5, (n, 3)), direction=d, contrib=rng.uniform(0.5, 2, n),
        timeDelta=rng.uniform(0, 10, n), hitPosition=rng.uniform(-1, 1, (n, 3)), hitDirection=-d,
        hitNormal=d,
    )
    if pol:
        rays["polRef"] = np.cross(d, [0.0, 0.0, 1.0])
    return rays


def _mesh_instance(pkg):
    """An icosphere turned in its own space: the untouched one has faces
    whose normals lie in the xy plane, where the local frame's sign of z
    (and so the whole frame) turns on the sign of a zero."""
    verts, faces = icosphere(1)
    verts = verts @ _rot((0.3, -0.7, 0.2), 0.4).T
    store = pkg.scene.MeshStore({"ball": pkg.mesh.Mesh.from_geometry(verts, faces)})
    T = pkg.scene.Transform
    return store.createInstance("ball", "any", T.TRS(scale=0.7, rotate=T.Rotation(1, 2, 3, 35), translate=(1, -2, 3)))


CAMERAS = {
    "pencil": lambda pkg: pkg.camera.PencilCamera(
        rayPosition=(12.0, -5.0, 3.2), rayDirection=_unit([1.0, -2.0, 0.4]), timeDelta=12.5,
        hitPosition=(0.3, 0.2, 0.1), hitDirection=_unit([0.0, 0.36, -0.48]), hitNormal=_unit([0.6, 0.0, 0.8]),
    ),
    "flat": lambda pkg: pkg.camera.FlatCamera(
        width=0.8, length=0.6, offset=(4.0, -2.0, 1.0), view=_rot((0.2, 1.0, -0.5), 0.7).T
    ),
    "cone": lambda pkg: pkg.camera.ConeCamera(position=(-8.0, 5.4, 3.0), direction=(0.36, 0.48, 0.80), cosOpeningAngle=0.12),
    "sphere": lambda pkg: pkg.camera.SphereCamera(position=(12.0, 5.0, -7.0), radius=4.0, timeDelta=12.5),
    "inner sphere": lambda pkg: pkg.camera.SphereCamera(position=(1.0, 2.0, 3.0), radius=-100.0),
    "point": lambda pkg: pkg.camera.PointCamera(position=(1.0, -2.0, 0.5), timeDelta=7.0),
    "mesh": lambda pkg: pkg.camera.MeshCamera(_mesh_instance(pkg), timeDelta=2.0),
    "mesh inward": lambda pkg: pkg.camera.MeshCamera(_mesh_instance(pkg), inward=True),
    "host": lambda pkg: pkg.camera.HostCamera(**_host_rays(300, False)),
    "host polarized": lambda pkg: pkg.camera.HostCamera(**_host_rays(300, True)),
}
DIRECT = ("flat", "cone", "sphere", "inner sphere", "mesh", "mesh inward")


def _params(cam, pkg):
    if pkg is theia_tpu:
        return cam.params()
    return cam.params("cpu")


def _state(pkg, n, key):
    if pkg is theia_tpu:
        return pkg.random.PhiloxRNG(key=key).state(jnp.arange(n, dtype=jnp.uint32))
    return pkg.random.PhiloxRNG(key=key).state(torch.arange(n, dtype=torch.int32))


def _numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(j, t, what):
    """Every field of two CameraRay or CameraSample records."""
    for f in dataclasses.fields(j):
        a, b = _numpy(getattr(j, f.name)), _numpy(getattr(t, f.name))
        assert (a is None) == (b is None), (what, f.name)
        if a is None:
            continue
        assert a.shape == b.shape, (what, f.name, a.shape, b.shape)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {f.name}")
        elif f.name == "contrib":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * float(np.abs(a).max()), err_msg=f"{what} {f.name}")
        elif f.name in ("pol_ref", "hit_pol_ref", "mueller"):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f"{what} {f.name}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-6 * max(1.0, float(np.abs(a).max())),
                                       err_msg=f"{what} {f.name}")


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_ray_mode_matches_jax(name):
    out = []
    for pkg in PACKAGES:
        cam = CAMERAS[name](pkg)
        lam = (jnp.full(N, 450.0, jnp.float32) if pkg is theia_tpu else torch.full((N,), 450.0))
        ray, rng = cam.sample_ray(_params(cam, pkg), lam, _state(pkg, N, 0xC0FFEE))
        out.append((ray, _numpy(rng.dim).astype(np.int64), cam.nRNGSamples))
    (jray, jdim, jn), (tray, tdim, tn) = out
    assert jn == tn
    np.testing.assert_array_equal(tdim, jdim)
    assert_same(jray, tray, name)


@pytest.mark.parametrize("name", DIRECT)
def test_direct_mode_matches_jax(name):
    """sample_point, then ray_from_point towards random light directions
    (half of them from behind the detector, which a camera rejects)."""
    dirs = np.random.default_rng(5).normal(size=(N, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    out = []
    for pkg in PACKAGES:
        cam = CAMERAS[name](pkg)
        p = _params(cam, pkg)
        if pkg is theia_tpu:
            lam, light = jnp.full(N, 450.0, jnp.float32), jnp.asarray(dirs)
        else:
            lam, light = torch.full((N,), 450.0), torch.as_tensor(dirs)
        pt, rng = cam.sample_point(p, lam, _state(pkg, N, 0xBEEF))
        out.append((pt, cam.ray_from_point(p, pt, light, lam), _numpy(rng.dim), cam.nRNGDirect))
    (jpt, jray, jdim, jn), (tpt, tray, tdim, tn) = out
    assert jn == tn and (tdim == jdim).all()
    assert_same(jpt, tpt, f"{name} point")
    assert_same(jray, tray, f"{name} connection")
    assert 0.0 < float((_numpy(tray.contrib) > 0).mean()) < 1.0


def test_flags_and_counts_match_jax():
    for name in CAMERAS:
        j, t = CAMERAS[name](theia_tpu), CAMERAS[name](theia_tpu_torch)
        assert (j.nRNGSamples, j.nRNGDirect, j.supportDirect) == (t.nRNGSamples, t.nRNGDirect, t.supportDirect), name


def test_scene_pieces_match_jax():
    """The scene pieces the cameras need: View, LookAt, applyVec,
    innerMatrix, offset, RectBBox.transform and SphereBBox."""
    J, T = theia_tpu.scene, theia_tpu_torch.scene
    for make in (
        lambda S: S.Transform.View(direction=(1.0, 2.0, -0.5), up=(0.0, 0.0, 1.0), position=(1.0, 2.0, 3.0)),
        lambda S: S.Transform.View(direction=(0.0, 1.0, 0.0)),  # up along the direction
        lambda S: S.Transform.LookAt(position=(4.0, 0.0, 1.0), target=(0.0, 1.0, -2.0)),
    ):
        j, t = make(J), make(T)
        np.testing.assert_array_equal(t.numpy(), j.numpy())
        np.testing.assert_array_equal(t.innerMatrix, j.innerMatrix)
        np.testing.assert_array_equal(t.offset, j.offset)
        v = np.random.default_rng(1).normal(size=(7, 3))
        np.testing.assert_array_equal(t.applyVec(v), j.applyVec(v))
        np.testing.assert_array_equal(t.copy().numpy(), j.numpy())
        jb, tb = J.RectBBox((-1, -2, -3), (1, 2, 3)).transform(j), T.RectBBox((-1, -2, -3), (1, 2, 3)).transform(t)
        assert tb.lowerCorner == jb.lowerCorner and tb.upperCorner == jb.upperCorner
        assert tb.diagonal == jb.diagonal
    s = T.SphereBBox((1, 2, 3), 4)
    assert (s.center, s.radius) == (J.SphereBBox((1, 2, 3), 4).center, 4.0)
