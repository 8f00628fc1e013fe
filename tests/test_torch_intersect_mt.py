"""theia_tpu_torch.ops.intersect_mt against the JAX Moeller-Trumbore kernel
(Pallas, interpret mode off-TPU) and the JAX brute-force scan.

Tolerances: the packs are built by the same numpy code and must be equal.
The nearest-hit winners may differ where two triangles' distances lie
within rounding, so idx must agree on >= 99.9 % of lanes; t is compared
where idx agrees. The port takes 1/det as the correctly rounded
reciprocal plus one Newton step. Against the JAX brute scan, which
divides exactly, t agrees to rtol 1e-5 (measured max 2.4e-6). The Pallas
kernel in interpret mode seeds its approximate reciprocal from a
bfloat16 value (2^-9 relative), which one Newton step only squares to
~1.5e-5 (measured), so against it t agrees to rtol 3e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu.accel import nearest_in_soup
from theia_tpu.ops import intersect_mt_pallas as jmt
from theia_tpu.ops import intersect_woop as jwoop
from theia_tpu_torch.ops import intersect_mt as tmt
from torch_flagship import build_flagship, icosphere

# the suite runs several xdist workers on one shared CPU: torch's intra-op
# threads in each of them oversubscribe it (the port's tests took 10x
# longer with the default thread count than with one thread per worker)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    mesh = icosphere(3)
    jt = build_flagship(theia_tpu, mesh, 64, 2)
    tt = build_flagship(theia_tpu_torch, mesh, 64, 2, device="cpu")
    return jt.scene.pack, tt.scene.pack


def _soup(pack, n=None):
    rows = np.asarray(pack.tri_data)
    n = rows.shape[0] if n is None else n
    return rows[:n, 18:21], rows[:n, 21:24], rows[:n, 24:27]


def test_scene_pack_equal(scenes):
    jp, tp = scenes
    np.testing.assert_array_equal(np.asarray(jp.tri_data), tp.tri_data.numpy())
    np.testing.assert_array_equal(np.asarray(jp.inst_data), tp.inst_data.numpy())
    for f in ("tri", "aabb", "lo", "hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jp.mt, f)), np.asarray(getattr(tp.mt, f)))
    assert jp.mt.n_tri == tp.mt.n_tri == 3840


@pytest.mark.parametrize("n_tri", [3840, 3000, 9000])
def test_morton_and_pack_equal(scenes, n_tri):
    """The flagship soup, one that is not a multiple of BT (2048), and
    one past 8192 triangles with BT = 512. The JAX pack_mt must be given
    that BT: with bt=None past 8192 triangles it raises UnboundLocalError
    (its local ``BT = bt`` shadows the module constant)."""
    bt = 512 if n_tri > tmt.SMALL_SCENE_MAX_TRI else None
    v0, e1, e2 = _soup(scenes[0])
    reps = -(-n_tri // v0.shape[0])
    v0, e1, e2 = (np.concatenate([a + 3.0 * k for k in range(reps)])[:n_tri] if a is v0
                  else np.concatenate([a] * reps)[:n_tri] for a in (v0, e1, e2))
    perm = jwoop.morton_order(v0, e1, e2)
    np.testing.assert_array_equal(perm, tmt.morton_order(v0, e1, e2))
    jp = jmt.pack_mt(v0[perm], e1[perm], e2[perm], bt)
    tp = tmt.pack_mt(v0[perm], e1[perm], e2[perm], device="cpu")
    assert tp.tri.shape[2] == (bt or tmt.SMALL_SCENE_BT)
    assert jp.n_tri == tp.n_tri == n_tri
    for f in ("tri", "aabb", "lo", "hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f)))


def _rays(n, seed, finite):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.0, -1.0, -1.0], [4.5, 4.0, 1.0], size=(n, 3)).astype(np.float32)
    # half the rays aim at points around the spheres, half go anywhere
    centers = np.asarray([[3.0, 0.0, 0.0], [0.0, 3.0, 0.0]])[rng.integers(0, 2, n)]
    aim = centers + rng.normal(scale=0.5, size=(n, 3))
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim - o, rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = (
        rng.uniform(0.5, 5.0, size=n).astype(np.float32)
        if finite
        else np.full(n, np.inf, np.float32)
    )
    return o, d, tmax


@pytest.mark.parametrize("finite", [False, True])
def test_nearest_matches_jax(scenes, finite):
    jp, tp = scenes
    o, d, tmax = _rays(4096, 3 + finite, finite)
    t_t, i_t = tmt.nearest_triangle_mt(
        tp.mt, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    )
    t_t, i_t = t_t.numpy(), i_t.numpy()
    assert tmt.nearest_triangle_mt.launches == 0  # CPU tensors never launch
    v0, e1, e2 = _soup(jp)
    refs = {
        "pallas": jmt.nearest_triangle_mt(jp.mt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)),
        "brute": nearest_in_soup(
            jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), 256,
        ),
    }
    hits = (i_t >= 0).mean()
    assert 0.2 < hits < 0.95  # the rays really exercise hits and misses
    rtol = {"pallas": 3e-5, "brute": 1e-5}
    for name, (t_j, i_j) in refs.items():
        t_j, i_j = np.asarray(t_j), np.asarray(i_j)
        same = i_t == i_j
        assert same.mean() >= 0.999, (name, same.mean())
        np.testing.assert_allclose(t_t[same], t_j[same], rtol=rtol[name], err_msg=name)


def test_chunk_skip_changes_nothing(scenes):
    """With unbounded chunk boxes and sub-boxes nothing is skipped; the
    result must be bit-identical to the skipping walk, grazing rays
    included."""
    _, tp = scenes
    o, d, tmax = _rays(4096, 9, False)
    # rays grazing the detector sphere's silhouette
    c = np.asarray([0.0, 3.0, 0.0], np.float32)
    o[:1024] = c + np.asarray([-5.0, 0.6, 0.0], np.float32) + np.float32(1e-4) * o[:1024]
    d[:1024] = np.asarray([1.0, 0.0, 0.0], np.float32)
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))
    got = tmt.nearest_triangle_mt_plain(tp.mt, *args)
    open_pack = tmt.MTPack(tp.mt.tri, tp.mt.aabb, tp.mt.lo, tp.mt.hi, tp.mt.n_tri)
    for boxes in (open_pack.chunk_box, open_pack.sub_box):
        boxes[:, 0:3] = -np.inf
        boxes[:, 4:7] = np.inf
    want = tmt.nearest_triangle_mt_plain(open_pack, *args)
    assert (got[1] >= 0).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_wrapper_checks_shapes(scenes):
    _, tp = scenes
    o = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        tmt.nearest_triangle_mt(tp.mt, o, torch.zeros(8, 3, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        tmt.nearest_triangle_mt(tp.mt, o.T, torch.zeros(3, 8).T, 1.0)


def test_mt_rows_plain(scenes):
    """The winner-row variant (the port of tools/exp_mt_fused.py): (t, idx)
    bit for bit the plain MT's, rows = tri_data[max(idx, 0)]."""
    _, tp = scenes
    o, d, tmax = (torch.as_tensor(a) for a in _rays(4096, 13, True))
    t, i = tmt.nearest_triangle_mt(tp.mt, o, d, tmax)
    t_r, i_r, rows = tmt.nearest_triangle_mt_rows(tp.mt, tp.tri_data, o, d, tmax)
    assert torch.equal(t_r, t) and torch.equal(i_r, i)
    assert (i >= 0).any() and (i < 0).any()
    assert torch.equal(rows, tp.tri_data[torch.clamp_min(i, 0).long()])
    assert rows.shape == (4096, 32)
    assert tmt.nearest_triangle_mt_rows.launches == 0
    with pytest.raises(ValueError):  # a table with fewer rows than triangles
        tmt.nearest_triangle_mt_rows(tp.mt, tp.tri_data[:100], o, d, tmax)


@pytest.mark.parametrize("n_tri", [1, 255, 256, 257, 3840])
def test_tri_aos_round_trip(scenes, n_tri):
    """The kernel's table: rows of v0, e1, e2 equal to the JAX-layout
    ``tri`` bit for bit, n = e1 x e2, a bounding sphere, finite slack
    coefficients, each row's index in the index column, whole chunks, and
    padding rows (all zero) that the exact test never hits."""
    v0, e1, e2 = _soup(scenes[0], n_tri)
    tp = tmt.pack_mt(v0, e1, e2, device="cpu")
    jp = jmt.pack_mt(v0, e1, e2, None)
    np.testing.assert_array_equal(np.asarray(jp.tri), tp.tri.numpy())
    aos = tp.tri_aos
    assert aos.shape == (-(-n_tri // tmt.CHUNK) * tmt.CHUNK, tmt.ROW_AOS) and aos.is_contiguous()
    exact_cols = list(range(12, 20)) + [10]  # v0, e1, e2 xy, and e2 z
    assert torch.equal(aos[:n_tri, exact_cols].T, tmt._rows(tp.tri, n_tri))
    np.testing.assert_array_equal(aos[:n_tri, exact_cols].numpy(), np.concatenate([v0, e1, e2], axis=1))
    np.testing.assert_allclose(
        aos[:n_tri, 4:7].numpy(), np.cross(e1.astype(np.float64), e2.astype(np.float64)), rtol=1e-6, atol=1e-12
    )
    # the bounding sphere holds the three vertices, with room to spare
    verts = np.stack([v0, v0 + e1, v0 + e2]).astype(np.float64)
    dist2 = ((verts - aos[:n_tri, 0:3].numpy().astype(np.float64)) ** 2).sum(-1).max(0)
    assert (aos[:n_tri, 3].numpy() >= 1.69 * dist2).all()
    assert torch.isfinite(aos).all() and (aos[:n_tri, 7:10] > 0).all()
    assert torch.equal(aos.view(torch.int32)[:n_tri, tmt.INDEX_COLUMN], torch.arange(n_tri, dtype=torch.int32))
    assert (aos[n_tri:] == 0).all()
    assert tp.chunk_count.tolist() == [min(tmt.CHUNK, n_tri - c0) for c0 in range(0, n_tri, tmt.CHUNK)]
    assert tp.chunks.tolist() == list(range(len(tp.chunk_count)))
    assert tp.sub_box.shape == (aos.shape[0] // tmt.SUB, 8)
    o, d, _ = (torch.as_tensor(a) for a in _rays(256, 17, False))
    _, hit = tmt._mt_exact_plain(aos[n_tri:, exact_cols].T, o, d)
    assert not hit.any()
    # the query reads tri, not tri_aos: a pack of n_tri triangles equals the
    # first n_tri of a larger soup only through the same rows
    t, i = tmt.nearest_triangle_mt(tp, o, d, torch.full((256,), torch.inf))
    assert int(i.max()) < n_tri
