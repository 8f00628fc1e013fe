"""The wavefront sort (``theia_tpu_torch.ops._intersect_tiles``) on the
CPU, against ``theia_tpu.ops._intersect_tiles``: the key and the stable
permutation bit for bit (NaN, infinite and huge origins, signed zeros and
NaN directions included), the binned MT, MT-with-rows and Woop queries
bit-equal to the unbinned ones with ``binned=True`` forced on a small pack,
the port's binned winners against JAX's ``run_binned``, the default
(unbinned on the port at either side of ``BIN_THRESHOLD``, where
``theia_tpu`` switches the sort on) and ``Scene(binned=True)`` routing a
tracer's queries through the sort with the same detections.

Tolerances and why: the key, the order and the binned queries are exact
(a sort is a permutation and each lane's winner is its own). Against
JAX's binned queries, tests/test_torch_intersect_woop.py's floor for
Woop (hit masks equal on >= 99.9 % of lanes, idx on >= 99.5 % of the hit
lanes, t within rtol 1e-4 / atol 1e-5 where idx agrees: JAX's interpret
mode seeds its reciprocal from a bfloat16 value) and
tests/test_torch_brute.py's for Moeller-Trumbore (the same shares, t
within 3e-4 relative: JAX divides by det, the port takes a reciprocal and
a Newton step)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu.ops import _intersect_tiles as jtiles
from theia_tpu.ops import intersect_mt_pallas as jmt
from theia_tpu.ops import intersect_woop as jwoop
from theia_tpu_torch.ops import _intersect_tiles as tiles
from theia_tpu_torch.ops import intersect_mt as tmt
from theia_tpu_torch.ops import intersect_woop as twoop
from torch_flagship import build_array, build_flagship, icosphere

torch.set_num_threads(1)


def wild_rays(n: int, seed: int):
    """Rays around and inside the bounds (-1, -2, -1.5)..(2, 1, 1), with
    NaN, infinite and huge origins, origins on the bounds, zero and
    negative-zero and NaN directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = n // 16
    o[0:k, 0] = np.nan
    o[k:2 * k, 1] = np.inf
    o[2 * k:3 * k, 2] = -np.inf
    o[3 * k:4 * k] = rng.choice([1e30, -1e30, 3e9, -3e9], (k, 3))
    o[4 * k:5 * k] = rng.choice([-1.0, 2.0, 0.5], (k, 3))
    d[5 * k:6 * k] = rng.choice([0.0, -0.0], (k, 3))
    d[6 * k:7 * k, 1] = np.nan
    return o, d


BOUNDS = (
    (np.array([-1.0, -2.0, -1.5], np.float32), np.array([2.0, 1.0, 1.0], np.float32)),
    (np.array([0.5, 0.5, 0.5], np.float32), np.array([0.5, 0.5, 0.5], np.float32)),  # span 1e-6
)


@pytest.mark.parametrize("n", [1, 1000, 2048, 5003])
@pytest.mark.parametrize("bounds", [0, 1])
def test_key_and_order_match_jax(n, bounds):
    lo, hi = BOUNDS[bounds]
    o, d = wild_rays(n, n + bounds)
    jkey = np.asarray(jtiles.octant_cell_key(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o), jnp.asarray(d)))
    jorder = np.asarray(jnp.argsort(jnp.asarray(jkey)))
    t_max = torch.arange(n, dtype=torch.float32)
    key, order, o_s, d_s, t_s = tiles.sort_rays(lo, hi, torch.as_tensor(o), torch.as_tensor(d), t_max)
    assert key.dtype == order.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), jkey)
    np.testing.assert_array_equal(tiles.octant_cell_key(lo, hi, torch.as_tensor(o), torch.as_tensor(d)).numpy(), jkey)
    np.testing.assert_array_equal(order.numpy(), jorder)
    assert torch.equal(t_s, t_max[order.long()])
    np.testing.assert_array_equal(o_s.numpy(), o[jorder])
    np.testing.assert_array_equal(d_s.numpy(), d[jorder])
    if n >= 1000 and bounds == 0:
        assert len(np.unique(jkey)) > 64, "the rays spread over the keys"
        assert 0 < (jkey < tiles.BIN_CELLS**3).sum() < n


def test_nonfinite_origins_follow_xla():
    """XLA's float->int cast saturates and maps NaN to 0 (torch's own cast
    gives INT_MIN for NaN and +inf): a NaN origin lands in cell 0, +inf in
    the last cell, -inf in cell 0, as in theia_tpu."""
    lo, hi = BOUNDS[0]
    o = np.array([[np.nan, 0, 0], [np.inf, 0, 0], [-np.inf, 0, 0], [1e30, 0, 0]], np.float32)
    d = np.ones((4, 3), np.float32)
    key = tiles.octant_cell_key(lo, hi, torch.as_tensor(o), torch.as_tensor(d)).numpy()
    jkey = np.asarray(jtiles.octant_cell_key(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_array_equal(key, jkey)
    x_cell = (key % tiles.BIN_CELLS**3) // tiles.BIN_CELLS**2
    assert x_cell.tolist() == [0, 3, 0, 3]


def test_scatter_back_inverts_the_sort():
    rng = np.random.default_rng(3)
    order = torch.as_tensor(rng.permutation(777).astype(np.int32))
    t, idx = torch.rand(777), torch.arange(777, dtype=torch.int32)
    rows = torch.rand(777, 32)
    bt, bi, br = tiles.scatter_back(order, t, idx, rows)
    assert torch.equal(bt[order.long()], t) and torch.equal(bi[order.long()], idx)
    assert torch.equal(br[order.long()], rows)
    assert len(tiles.scatter_back(order, t, idx)) == 2


@pytest.fixture(scope="module")
def packs():
    mesh = icosphere(2)
    mt = build_flagship(theia_tpu_torch, mesh, 64, 2, accel="mt", device="cpu").scene.pack
    woop = build_flagship(theia_tpu_torch, mesh, 64, 2, accel="woop", device="cpu").scene.pack
    return mt, woop


def aimed_rays(n: int, seed: int):
    """Rays from around the flagship's spheres, half aimed at their
    centres, half with finite bounds."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 4.5, (n, 3)).astype(np.float32)
    centres = np.asarray([[3.0, 0.0, 0.0], [0.0, 3.0, 0.0], [0.0, 0.0, 0.0]])[rng.integers(0, 3, n)]
    aim = centres + rng.normal(scale=0.4, size=(n, 3)) - o
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim, rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.2, 3.0, n), np.inf).astype(np.float32)
    return o, d, t


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("query", ["mt", "mt_rows", "woop"])
def test_binned_equals_unbinned(packs, query):
    mt, woop = packs
    o, d, t = (torch.as_tensor(a) for a in aimed_rays(3001, 7))
    if query == "mt":
        run = lambda b: tmt.nearest_triangle_mt(mt.mt, o, d, t, binned=b)
    elif query == "mt_rows":
        run = lambda b: tmt.nearest_triangle_mt_rows(mt.mt, mt.tri_data, o, d, t, binned=b)
    else:
        run = lambda b: twoop.nearest_triangle_woop(woop.woop, o, d, t, binned=b)
    plain, binned = run(False), run(True)
    assert (plain[1] >= 0).float().mean() > 0.1
    assert same_bits(binned[0], plain[0]) and torch.equal(binned[1], plain[1])
    if query == "mt_rows":
        assert same_bits(binned[2], plain[2])


def test_binned_takes_a_scalar_bound(packs):
    mt, _ = packs
    o, d, _ = (torch.as_tensor(a) for a in aimed_rays(999, 9))
    plain = tmt.nearest_triangle_mt(mt.mt, o, d, 2.5, binned=False)
    binned = tmt.nearest_triangle_mt(mt.mt, o, d, 2.5, binned=True)
    assert (plain[1] >= 0).any() and same_bits(binned[0], plain[0]) and torch.equal(binned[1], plain[1])


def assert_winners(t, idx, jt, jidx, t_rtol):
    t, idx, jt, jidx = (np.asarray(a) for a in (t, idx, jt, jidx))
    hit, jhit = idx >= 0, jidx >= 0
    assert 0.1 < hit.mean() < 0.95
    assert (hit == jhit).mean() >= 0.999
    both = hit & jhit
    assert (idx[both] == jidx[both]).mean() >= 0.995
    same = both & (idx == jidx)
    np.testing.assert_allclose(t[same], jt[same], rtol=t_rtol, atol=1e-5)


def test_binned_woop_matches_jax_run_binned(packs):
    _, woop = packs
    jpack = build_flagship(theia_tpu, icosphere(2), 64, 2, accel="woop").scene.pack.woop
    o, d, t = aimed_rays(2048, 8)
    jt, ji = jwoop.nearest_triangle_woop(jpack, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), binned=True)
    tt, ti = twoop.nearest_triangle_woop(woop.woop, *(torch.as_tensor(a) for a in (o, d, t)), binned=True)
    assert_winners(tt.numpy(), ti.numpy(), jt, ji, 1e-4)


def random_soup(n_tri: int, seed: int):
    """``n_tri`` small triangles scattered through a 4 m box, in Morton
    order (as the packs take them)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2.0, 2.0, (n_tri, 3)).astype(np.float32)
    e1, e2 = (rng.normal(scale=0.05, size=(n_tri, 3)).astype(np.float32) for _ in range(2))
    order = tmt.morton_order(v0, e1, e2)
    return v0[order], e1[order], e2[order]


@pytest.mark.parametrize("n_tri", [tiles.BIN_THRESHOLD - 1, tiles.BIN_THRESHOLD])
def test_default_bins_from_the_threshold(monkeypatch, n_tri):
    """The port's queries do not sort by default on either side of
    BIN_THRESHOLD (a kept divergence: theia_tpu's sort from there on, the
    port's scan culls each ray on its own and the sorted query measured
    slower on the card), and their default winners are JAX's default
    Moeller-Trumbore query's, binned at the threshold (JAX's pack_mt takes
    up to 8192 triangles)."""
    soup = random_soup(n_tri, n_tri)
    calls = []
    sort_rays = tiles.sort_rays
    monkeypatch.setattr(tiles, "sort_rays", lambda *a: calls.append(a[2].shape[0]) or sort_rays(*a))
    rng = np.random.default_rng(1)
    o = rng.uniform(-2.5, 2.5, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    t = np.full(512, np.inf, np.float32)
    rays = tuple(torch.as_tensor(a) for a in (o, d, t))
    mt = tmt.pack_mt(*soup, device="cpu")
    tt, ti = tmt.nearest_triangle_mt(mt, *rays)
    twoop.nearest_triangle_woop(twoop.pack_woop(*soup, device="cpu"), *rays)
    assert calls == []
    tmt.nearest_triangle_mt(mt, *rays, binned=True)
    assert calls == [512]
    jt, ji = jmt.nearest_triangle_mt(jmt.pack_mt(*soup), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    assert_winners(tt.numpy(), ti.numpy(), jt, ji, 3e-4)


@pytest.mark.parametrize("accel", ["mt", "woop"])
def test_scene_binned_routes_through_the_sort(monkeypatch, accel):
    """``Scene(binned=True)`` (through ``SceneTemplate.createScene``) has
    every nearest-hit query of a batch sort its rays, and the batch's
    detections are the unbinned scene's bit for bit."""
    calls = []
    sort_rays = tiles.sort_rays
    monkeypatch.setattr(tiles, "sort_rays", lambda *a: calls.append(a[2].shape[0]) or sort_rays(*a))
    results = {}
    for binned in (False, True):
        tracer = build_array(theia_tpu_torch, icosphere(1), 256, 3, accel=accel, device="cpu", binned=binned)
        pack = tracer.scene.pack
        assert (pack.mt if accel == "mt" else pack.woop).binned is binned
        results[binned], _ = tracer.run()
        assert len(calls) == (3 if binned else 0), calls
    assert int(results[False]["valid"].sum()) > 0
    assert results[True].keys() == results[False].keys()
    for k, v in results[False].items():
        assert torch.equal(v.view(torch.int32) if v.dtype == torch.float32 else v, (
            results[True][k].view(torch.int32) if v.dtype == torch.float32 else results[True][k])), k


def test_kernel_constants_match_the_module():
    """The sort's kernel sizes its scratch and its grid by the module's
    constants: kCells, kKeys and kTile in csrc/wavefront_sort.cu."""
    import re
    from pathlib import Path

    src = (Path(tiles.__file__).resolve().parents[1] / "csrc" / "wavefront_sort.cu").read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    assert int(const("kCells")) == tiles.BIN_CELLS
    assert const("kKeys") == "8 * kCells * kCells * kCells" and tiles.BIN_KEYS == 8 * tiles.BIN_CELLS**3
    assert int(const("kTile")) == tiles.SORT_TILE
    assert "sort_rays" in tiles.__all__ and "scatter_back" in tiles.__all__
