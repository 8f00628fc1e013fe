"""theia_tpu_torch.mesh's file loaders, MeshStore with file paths and
SceneTemplate.fromFile against theia_tpu's, on files that the tests write
(binary and ASCII STL, ASCII and binary PLY with triangles and quads, OBJ
with named objects, materials, quads and relative indices).

Tolerance: the loaders are the same numpy code, so every array is equal
bit for bit to JAX's ``loadMesh`` / ``loadObjScene``, and a loaded file
equals ``Mesh.from_geometry`` of the float32 corners it holds. The
scenes built from files are held bit for bit against their in-memory
twins: every table of the pack, and one batch's recorded hits."""

import numpy as np
import pytest
import torch

import theia_tpu
import theia_tpu.mesh as jmesh
import theia_tpu.render as jrender
import theia_tpu_torch
import theia_tpu_torch.mesh as tmesh
import theia_tpu_torch.render as trender
from theia_tpu_torch.scene import MeshInstance, MeshStore, Transform
from torch_flagship import (
    array_obj, build_array_from_template, build_flagship, icosphere, write_obj, write_ply, write_stl,
)

torch.set_num_threads(1)


def same_mesh(a, b):
    assert a.vertices.dtype == b.vertices.dtype == np.float32 and a.indices.dtype == b.indices.dtype == np.int32
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.indices, b.indices)


def from_corners(tri):
    return tmesh.Mesh.from_geometry(tri.reshape(-1, 3), np.arange(3 * len(tri)).reshape(-1, 3))


@pytest.mark.parametrize("ascii", [False, True])
def test_stl_matches_jax_and_its_corners(tmp_path, ascii):
    path = tmp_path / "sphere.stl"
    tri = write_stl(path, icosphere(2), ascii=ascii)
    got = tmesh.loadMesh(path)
    same_mesh(got, jmesh.loadMesh(path))
    same_mesh(got, from_corners(tri))
    assert got.indices.shape == (320, 3) and got.vertices.shape == (162, 6)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("quads", [False, True])
def test_ply_matches_jax(tmp_path, binary, quads):
    path = tmp_path / "mesh.ply"
    if quads:  # a cube of six quads, fanned into twelve triangles
        pos = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float64)
        faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                          [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
        mesh = (pos, faces)
    else:
        mesh = icosphere(1)
    write_ply(path, mesh, binary=binary, quads=quads)
    got = tmesh.loadMesh(path)
    same_mesh(got, jmesh.loadMesh(path))
    same_mesh(got, tmesh.Mesh.from_geometry(np.asarray(mesh[0], np.float32), mesh[1]))


def test_obj_scene_matches_jax(tmp_path):
    path = tmp_path / "scene.obj"
    pos, faces = icosphere(1)
    quad_pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float64)
    write_obj(path, [("ball", "det", pos, faces), ("plate", "glass", quad_pos, [[0, 1, 2, 3]]),
                     ("ball", None, pos + 3.0, faces)])
    got, want = tmesh.loadObjScene(path), jmesh.loadObjScene(path)
    assert [(o.name, o.material) for o in got] == [(o.name, o.material) for o in want] == [
        ("ball", "det"), ("plate", "glass"), ("ball.001", "glass")]
    for a, b in zip(got, want):
        same_mesh(a.mesh, b.mesh)
    assert got[1].mesh.indices.shape == (2, 3)  # the quad's fan
    same_mesh(tmesh.loadMesh(path), jmesh.loadMesh(path))
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nf 1 2 3\n")
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="out of range"):
            mod.loadMesh(bad)
        with pytest.raises(ValueError, match="unsupported mesh format"):
            mod.loadMesh(tmp_path / "mesh.3ds")


def test_mesh_store_takes_paths(tmp_path):
    write_stl(tmp_path / "a.stl", icosphere(1))
    store = MeshStore({"a": tmp_path / "a.stl", "b": str(tmp_path / "a.stl"), "c": tmesh.loadMesh(tmp_path / "a.stl")})
    inst = [store.createInstance(k, "m") for k in "abc"]
    for i in inst[1:]:
        same_mesh(i.mesh, inst[0].mesh)


def test_flagship_from_stl_equals_its_twin(tmp_path):
    """Phase 3n's flagship-brute-from-stl, small: the flagship's three
    meshes loaded from a binary STL against the same scene built from the
    written float32 corners in memory; every pack table bit for bit, and
    one batch's recorded hits bit for bit."""
    mesh = icosphere(2)
    tri = write_stl(tmp_path / "sphere.stl", mesh)
    twin = (tri.reshape(-1, 3).astype(np.float64), np.arange(3 * len(tri)).reshape(-1, 3))
    resp = lambda: theia_tpu_torch.response.HitRecorder()
    a = build_flagship(theia_tpu_torch, tmp_path / "sphere.stl", 1024, 4, accel="auto", device="cpu", response=resp())
    b = build_flagship(theia_tpu_torch, twin, 1024, 4, accel="auto", device="cpu", response=resp())
    assert a.scene.accel == b.scene.accel == "brute"
    for name in ("tri_data", "inst_data"):
        assert torch.equal(getattr(a.scene.pack, name), getattr(b.scene.pack, name)), name
    assert torch.equal(a.scene.pack.soup.aos, b.scene.pack.soup.aos)
    ha, hb = a.run()[0], b.run()[0]
    assert int(ha["valid"].sum()) > 0
    for key in ha:
        assert torch.equal(ha[key], hb[key]), key
    j = build_flagship(theia_tpu, tmp_path / "sphere.stl", 64, 2, accel="brute")
    np.testing.assert_array_equal(np.asarray(j.scene.pack.tri_data), a.scene.pack.tri_data.numpy())


@pytest.mark.parametrize("how", [dict(), dict(detectorMaterial={"det"}), dict(detectorIdMap={"shell_b": 7})])
def test_from_file_detector_ids_match_jax(tmp_path, how):
    path = tmp_path / "template.obj"
    tet = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64),
           np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]))
    write_obj(path, [("det_a", "det", *tet), ("shell_b", "glass", tet[0] + (2.0, 0.0, 0.0), tet[1])])
    got, want = trender.SceneTemplate.fromFile(path, **how), jrender.SceneTemplate.fromFile(path, **how)
    assert got.idStride == want.idStride
    assert [(i.key, i.material, i.detectorId) for i in got.instances] == [
        (i.key, i.material, i.detectorId) for i in want.instances]
    assert got.detectorIds(3) == want.detectorIds(3)
    m = theia_tpu_torch.material
    store = m.MaterialStore.pack([m.Material("det", None, None, flags="DB"), m.Material("glass", None, None, flags="TR")],
                                 device="cpu")
    transforms = [Transform.Translation(0.0, 0.0, 0.0), Transform.Translation(10.0, 0.0, 0.0)]
    scene = got.createScene(transforms, store, medium=None, device="cpu")
    jm = theia_tpu.material
    jstore = jm.MaterialStore.pack([jm.Material("det", None, None, flags="DB"), jm.Material("glass", None, None, flags="TR")])
    jscene = want.createScene([theia_tpu.scene.Transform.Translation(*t.apply(np.zeros((1, 3)))[0]) for t in transforms],
                              jstore, medium=None)
    assert [i.detectorId for i in scene.instances] == [i.detectorId for i in jscene.instances]
    with pytest.raises(ValueError, match="no material"):
        bare = tmp_path / "bare.obj"
        write_obj(bare, [("x", None, *tet)])
        trender.SceneTemplate.fromFile(bare)


def test_array_from_obj_equals_the_in_memory_array(tmp_path):
    """Phase 3n's array-from-obj, small: example 08's 26 modules stamped by
    SceneTemplate.fromFile from an OBJ against the same array stamped in
    memory from the loaded mesh (same stride): ids, pack and one batch's
    recorded hits bit for bit; "auto" picks the instanced walk."""
    path = tmp_path / "module.obj"
    array_obj(path, icosphere(2))
    tpl = trender.SceneTemplate.fromFile(path)
    loaded = tmesh.loadObjScene(path)[0]
    twin = trender.SceneTemplate([MeshInstance("module", loaded.mesh, "det_shell", Transform(), 1)], idStride=1)
    assert tpl.detectorIds(26) == twin.detectorIds(26) == jrender.SceneTemplate.fromFile(path).detectorIds(26)
    a = build_array_from_template(theia_tpu_torch, tpl, 1024, 4, device="cpu")
    b = build_array_from_template(theia_tpu_torch, twin, 1024, 4, device="cpu")
    assert a.scene.accel == b.scene.accel == "instanced"
    assert [i.detectorId for i in a.scene.instances] == [i.detectorId for i in b.scene.instances] == list(range(1, 27))
    for name in ("tri_data", "inst_data"):
        assert torch.equal(getattr(a.scene.pack, name), getattr(b.scene.pack, name)), name
    ha, hb = a.run()[0], b.run()[0]
    assert int(ha["valid"].sum()) > 0
    for key in ha:
        assert torch.equal(ha[key], hb[key]), key
