"""theia_tpu_torch.ops.intersect_woop against the JAX Woop kernel (Pallas,
interpret mode off-TPU) and against the port's own Moeller-Trumbore query.

Tolerances: the packs are built by the same numpy code (float64 before
the cast to float32, the |det| < 1e-30 cutoff on the host) and must be
equal. Against JAX the floor is tests/test_woop.py's: t within rtol 1e-4
/ atol 1e-5 where idx agrees, idx equal on >= 99.5 % of hit lanes, hit
masks equal on >= 99.9 %. The JAX kernel in interpret mode seeds its
reciprocal from a bfloat16 value (one Newton step leaves ~1.5e-5
relative) and XLA's CPU dot may sum o' and d' in another order; the
port reaches equal hit masks and idx on every lane and t within 3.7e-5
relative (measured on both ray sets). Woop and Moeller-Trumbore test the
same triangles in different arithmetic; they must pick the same winner
on >= 99.5 % of lanes, with t within rtol 1e-4 (measured: every lane,
t within 8.2e-5, degenerate soup included)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu.ops import intersect_woop as jwoop
from theia_tpu_torch.ops import intersect_mt as tmt
from theia_tpu_torch.ops import intersect_woop as twoop
from torch_flagship import build_flagship, icosphere

# the suite runs several xdist workers on one shared CPU: torch's intra-op
# threads in each of them oversubscribe it (the port's tests took 10x
# longer with the default thread count than with one thread per worker)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    mesh = icosphere(3)
    jt = build_flagship(theia_tpu, mesh, 64, 2, accel="woop")
    tt = build_flagship(theia_tpu_torch, mesh, 64, 2, accel="woop", device="cpu")
    return jt.scene.pack, tt.scene.pack


def _soup(pack):
    rows = np.asarray(pack.tri_data)
    return rows[:, 18:21], rows[:, 21:24], rows[:, 24:27]


def _degenerate_soup(pack, n_tri=3000):
    """The first ``n_tri`` flagship triangles (not a multiple of 512), with
    every 97th one collapsed to a line (|det| < 1e-30 on the host)."""
    v0, e1, e2 = (a[:n_tri].copy() for a in _soup(pack))
    e2[::97] = 2.0 * e1[::97]
    return v0, e1, e2


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


def _assert_packs_equal(jp, tp):
    for f in ("b", "aabb", "lo", "hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f)), err_msg=f)
    assert jp.n_tri == tp.n_tri


def test_scene_pack_equal(scenes):
    jp, tp = scenes
    assert tp.mt is None and tp.woop is not None
    np.testing.assert_array_equal(np.asarray(jp.tri_data), tp.tri_data.numpy())
    _assert_packs_equal(jp.woop, tp.woop)
    assert tp.woop.n_tri == 3840 and tp.woop.b.shape == (8, 8, 6 * 512)


@pytest.mark.parametrize("degenerate", [False, True])
def test_pack_woop_equal(scenes, degenerate):
    """The flagship soup, and a soup of 3000 triangles (5.9 tiles of 512)
    with degenerate triangles, whose transforms are 0 with offset 3e38."""
    soup = _degenerate_soup(scenes[0]) if degenerate else _soup(scenes[0])
    jp = jwoop.pack_woop(*soup)
    tp = twoop.pack_woop(*soup, device="cpu")
    _assert_packs_equal(jp, tp)
    if degenerate:
        b = tp.b.numpy()
        assert (b[0, 3, :512][::97] == np.float32(3e38)).all()
        assert (b[0, 0:3, :512][:, ::97] == 0.0).all()


@pytest.mark.parametrize("finite", [False, True])
def test_nearest_matches_jax(scenes, finite):
    jp, tp = scenes
    o, d, tmax = _rays(4096, 5 + finite, finite)
    t_t, i_t = twoop.nearest_triangle_woop(
        tp.woop, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    )
    t_t, i_t = t_t.numpy(), i_t.numpy()
    t_j, i_j = jwoop.nearest_triangle_woop(jp.woop, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    t_j, i_j = np.asarray(t_j), np.asarray(i_j)
    hit_t, hit_j = i_t >= 0, i_j >= 0
    assert 0.2 < hit_t.mean() < 0.95  # the rays really exercise hits and misses
    assert (hit_t == hit_j).mean() >= 0.999
    both = hit_t & hit_j
    assert (i_t[both] == i_j[both]).mean() >= 0.995
    same = both & (i_t == i_j)
    np.testing.assert_allclose(t_t[same], t_j[same], rtol=1e-4, atol=1e-5)
    assert np.isinf(t_t[~hit_t]).all()


@pytest.mark.parametrize("degenerate", [False, True])
def test_woop_agrees_with_mt(scenes, degenerate):
    """Plain Woop against plain Moeller-Trumbore on one Morton soup."""
    soup = _degenerate_soup(scenes[0]) if degenerate else _soup(scenes[0])
    wp = twoop.pack_woop(*soup, device="cpu")
    mp = tmt.pack_mt(*soup, device="cpu")
    torch.testing.assert_close(wp.chunk_box, mp.chunk_box, rtol=0, atol=0)
    o, d, tmax = (torch.as_tensor(a) for a in _rays(4096, 11, False))
    t_w, i_w = twoop.nearest_triangle_woop(wp, o, d, tmax)
    t_m, i_m = tmt.nearest_triangle_mt(mp, o, d, tmax)
    assert (i_w >= 0).float().mean() > 0.2
    assert (i_w == i_m).float().mean() >= 0.995
    same = (i_w == i_m) & (i_w >= 0)
    torch.testing.assert_close(t_w[same], t_m[same], rtol=1e-4, atol=1e-5)


def test_chunk_skip_changes_nothing(scenes):
    """With unbounded chunk boxes and sub-boxes nothing is skipped; the
    result must be bit-identical to the skipping walk, grazing rays
    included."""
    _, tp = scenes
    o, d, tmax = _rays(4096, 9, False)
    c = np.asarray([0.0, 3.0, 0.0], np.float32)
    o[:1024] = c + np.asarray([-5.0, 0.6, 0.0], np.float32) + np.float32(1e-4) * o[:1024]
    d[:1024] = np.asarray([1.0, 0.0, 0.0], np.float32)
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))
    got = twoop.nearest_triangle_woop_plain(tp.woop, *args)
    w = tp.woop
    open_boxes = w.chunk_box.clone(), w.sub_box.clone()
    for boxes in open_boxes:
        boxes[:, 0:3] = -np.inf
        boxes[:, 4:7] = np.inf
    want = twoop.nearest_triangle_woop_plain(
        twoop.WoopPack(w.b, w.aabb, w.lo, w.hi, w.n_tri, *open_boxes), *args
    )
    assert (got[1] >= 0).any()
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), x.numpy())


def test_cpu_launches_no_kernel_and_checks_shapes(scenes):
    _, tp = scenes
    o = torch.zeros(8, 3)
    twoop.nearest_triangle_woop(tp.woop, o, torch.ones(8, 3), 1.0)
    assert twoop.nearest_triangle_woop.launches == 0
    with pytest.raises(ValueError):
        twoop.nearest_triangle_woop(tp.woop, o, torch.zeros(8, 3, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        twoop.nearest_triangle_woop(tp.woop, o.T, torch.zeros(3, 8).T, 1.0)


@pytest.mark.parametrize("n_tri", [1, 255, 256, 257, 3840])
def test_tri_aos_round_trip(scenes, n_tri):
    """The kernel's table: rows of m and f equal to the JAX-layout ``b``
    bit for bit, a bounding sphere and finite slack coefficients for real
    triangles, an infinite one for degenerate ones, each row's index in the
    index column, whole chunks, and padding rows (all zero) that the exact
    test never hits."""
    v0, e1, e2 = (a[:n_tri].copy() for a in _soup(scenes[0]))
    if n_tri > 100:
        e2[::97] = 2.0 * e1[::97]  # degenerate: m = 0, f = 3e38
    tp = twoop.pack_woop(v0, e1, e2, device="cpu")
    _assert_packs_equal(jwoop.pack_woop(v0, e1, e2), tp)
    aos = tp.tri_aos
    assert aos.shape == (-(-n_tri // tmt.CHUNK) * tmt.CHUNK, tmt.ROW_AOS) and aos.is_contiguous()
    m = twoop._transforms(tp.b, n_tri)
    rows = torch.cat([aos[:, 12:20], aos[:, 4:8]], dim=1)  # m_b1 f_b1 m_b2 f_b2 m_z f_z
    assert torch.equal(rows[:n_tri].T, m)
    degenerate = m[3] == np.float32(3e38)
    assert degenerate.any() == (n_tri > 100)
    assert torch.isfinite(aos[:n_tri][~degenerate]).all()
    assert torch.isinf(aos[:n_tri, 9][degenerate]).all()
    assert (aos[:n_tri, 8:10][~degenerate] > 0).all()
    # the bounding sphere holds the three world vertices, with room to spare
    # (it is built from the float32 map, which moves them by rounding only)
    verts = np.stack([v0, v0 + e1, v0 + e2]).astype(np.float64)
    dist2 = ((verts - aos[:n_tri, 0:3].numpy().astype(np.float64)) ** 2).sum(-1).max(0)
    keep = ~degenerate.numpy()
    assert (aos[:n_tri, 3].numpy()[keep] >= 2.79 * dist2[keep]).all()
    assert (aos[n_tri:] == 0).all() and (aos[:, 10] == 0).all()
    assert torch.equal(aos.view(torch.int32)[:n_tri, tmt.INDEX_COLUMN], torch.arange(n_tri, dtype=torch.int32))
    assert tp.chunk_count.tolist() == [min(tmt.CHUNK, n_tri - c0) for c0 in range(0, n_tri, tmt.CHUNK)]
    assert tp.sub_box.shape == (aos.shape[0] // tmt.SUB, 8)
    o, d, _ = (torch.as_tensor(a) for a in _rays(256, 17, False))
    _, hit = twoop._woop_exact_plain(rows[n_tri:].T, o, d)
    assert not hit.any()
    _, hit = twoop._woop_exact_plain(m[:, degenerate], o, d)
    assert not hit.any()
