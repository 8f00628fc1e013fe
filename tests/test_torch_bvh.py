"""The threaded-BVH backend of the port (``accel="bvh"``) against the live
JAX reference on the CPU, on in-code icosphere arrays
(``torch_flagship.array_scene``: 27 spheres of 320 triangles, with a
second prototype where ``mixed``).

Tolerances and why:
(a) builders and packs: equal bit for bit. The port's ``bvh.cpp`` is a
    copy of ``theia_tpu``'s and its numpy twin repeats its decisions; the
    nodes' two link fields are compared as int32 bits.
(b) queries against ``theia_tpu``: hit or miss the same on >= 99.9 % of
    lanes, the same winner on >= 99.5 % of the lanes both hit, t within
    4 ulps on 90 % of them and rtol 3e-4 on all (tests/test_torch_brute.py's
    limits): the walk visits the same nodes, but the port's exact test
    takes a correctly rounded reciprocal and a Newton step where JAX
    divides, so t differs by ulps and a lane whose ray meets two triangles
    within ulps (a shared edge) may pick the other.
(c) against the port's brute-force scan on the same triangles: t bit for
    bit where the winner is the same (one exact test), the same winner on
    >= 99.9 % of the lanes (a tie goes to the first triangle in threaded
    order here, to the lowest row there).
(d) the any-hit equals ``nearest < t_max`` bit for bit (one walk, one
    test), and ``theia_tpu``'s any-hit on >= 99.9 % of lanes (b).
(e) a traced batch of the flagship on ``accel="bvh"``: RNG dims equal on
    >= 99.5 % of lanes, histogram sum rtol 1e-3, per-bin L1 <= 1 %
    (tests/test_torch_scene_tracer.py's limits, for the same reasons).
(f) scenes whose hits tie exactly (``torch_flagship.tie_scene``: every
    triangle twice in neighbouring rows, or two instances in one place):
    (b) against ``theia_tpu`` and (c) against the brute scan (here the
    first triangle in threaded order wins a tie, there the lowest row;
    the tests hold them to (c)'s share all the same); the any-hit as (d).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu.native import _build_numpy as jax_build_numpy
from theia_tpu.ops import bvh_traverse as jbvh
from theia_tpu_torch import accel as taccel
from theia_tpu_torch.native import _build_numpy, build_bvh
from theia_tpu_torch.ops import bvh_traverse as tbvh
from torch_flagship import (
    TIE_KINDS, array_rays, array_scene, assert_winners_match, build_flagship, icosphere, tie_scene, uniform_rays,
)

torch.set_num_threads(1)

N_RAYS = 4096


@pytest.fixture(scope="module")
def scenes():
    return {
        mixed: (array_scene(theia_tpu, "bvh", mixed=mixed), array_scene(theia_tpu_torch, "bvh", mixed=mixed, device="cpu"))
        for mixed in (False, True)
    }


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_builders_agree(leaf_size):
    """The compiled builder, its numpy twin and ``theia_tpu``'s numpy
    builder make the same tree, array for array."""
    pack = array_scene(theia_tpu_torch, "brute", mixed=True, device="cpu").pack
    soup = [a.numpy() for a in (pack.w_v0, pack.w_e1, pack.w_e2)]
    trees = [build_bvh(*soup, leaf_size=leaf_size), _build_numpy(*soup, leaf_size), jax_build_numpy(*soup, leaf_size)]
    for name in ("bmin", "bmax", "miss", "start", "count", "order"):
        want = getattr(trees[2], name)
        for tree in trees[:2]:
            got = getattr(tree, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
    leaves = trees[0].start >= 0
    assert trees[0].count[leaves].max() <= leaf_size and sorted(trees[0].order.tolist()) == list(range(len(soup[0])))


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_pack_equals_jax(leaf_size):
    """``Scene(accel="bvh", leaf_size=...)``: the walk's tables and the
    reconstruction rows equal ``theia_tpu``'s bit for bit."""
    jp = _scene_with_leaf(theia_tpu, leaf_size).pack
    tp = _scene_with_leaf(theia_tpu_torch, leaf_size, device="cpu").pack
    assert tp.bvh.leaf_size == jp.bvh.leaf_size == leaf_size
    assert np.array_equal(tp.bvh.nodes.view(torch.int32).numpy(), np.asarray(jp.bvh.nodes).view(np.int32))
    assert np.array_equal(tp.bvh.tri.numpy(), np.asarray(jp.bvh.tri))
    assert np.array_equal(tp.bvh.order.numpy(), np.asarray(jp.bvh.order))
    for name in ("tri_data", "inst_data", "w_v0", "w_e1", "w_e2"):
        assert np.array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name))), name
    assert tp.soup is None and tp.mt is None and tp.woop is None and tp.instanced is None and tp.cull is None


def test_leaf_size_is_checked():
    """A leaf's count has 5 bits in the packed node row: leaf sizes from 1
    to 31 build, others raise before the builder runs."""
    for leaf_size in (0, 32):
        with pytest.raises(ValueError, match="leaf_size"):
            _scene_with_leaf(theia_tpu_torch, leaf_size, device="cpu")
    pack = _scene_with_leaf(theia_tpu_torch, 31, device="cpu").pack
    assert int((pack.bvh.nodes.view(torch.int32)[:, 7] & 31).max()) <= 31


def _scene_with_leaf(pkg, leaf_size, device=None):
    base = array_scene(pkg, "brute", mixed=True, device=device)
    dev = {} if device is None else {"device": device}
    return pkg.scene.Scene(base.instances, base.materials, medium=None, accel="bvh", leaf_size=leaf_size, **dev)


@pytest.mark.parametrize("mixed", [False, True])
def test_nearest_matches_jax(scenes, mixed):
    jscene, tscene = scenes[mixed]
    o, d = uniform_rays(N_RAYS, 1 + mixed)
    jt, jidx = jbvh.nearest_triangle_bvh(jscene.pack.bvh, jnp.asarray(o), jnp.asarray(d), jnp.inf)
    t, idx = tbvh.nearest_triangle_bvh(tscene.pack.bvh, torch.as_tensor(o), torch.as_tensor(d), torch.inf)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    assert bool(torch.isinf(t[idx < 0]).all())
    assert_winners_match(t, idx, jt, jidx)


def test_respects_t_max(scenes):
    """A hit counts only strictly before t_max: a capped query keeps the
    winners in front of the cap and misses behind it."""
    tscene = scenes[False][1]
    o, d = (torch.as_tensor(a) for a in uniform_rays(N_RAYS, 3))
    t_far, i_far = tbvh.nearest_triangle_bvh(tscene.pack.bvh, o, d, torch.inf)
    cap = 1.5
    t_cap, i_cap = tbvh.nearest_triangle_bvh(tscene.pack.bvh, o, d, cap)
    beyond = (i_far >= 0) & (t_far >= cap)
    within = (i_far >= 0) & (t_far < cap)
    assert bool(beyond.any()) and bool(within.any())
    assert bool((i_cap[beyond] == -1).all())
    assert torch.equal(i_cap[within], i_far[within]) and torch.equal(t_cap[within], t_far[within])
    # a t_max exactly at the hit excludes it
    t_at, i_at = tbvh.nearest_triangle_bvh(tscene.pack.bvh, o, d, torch.where(i_far >= 0, t_far, torch.inf))
    assert bool((i_at[i_far >= 0] != i_far[i_far >= 0]).float().mean() > 0.99)


def test_anyhit_is_nearest_below_t_max(scenes):
    """Tolerance (d): on per-lane bounds around the hits, a quarter of them
    infinite."""
    jscene, tscene = scenes[True]
    o, d = uniform_rays(N_RAYS, 4)
    rng = np.random.default_rng(5)
    t_max = np.where(rng.uniform(size=N_RAYS) < 0.25, np.inf, rng.uniform(0.1, 6.0, N_RAYS)).astype(np.float32)
    o_t, d_t, tm = (torch.as_tensor(a) for a in (o, d, t_max))
    occ = tbvh.occluded_bvh(tscene.pack.bvh, o_t, d_t, tm)
    _, idx = tbvh.nearest_triangle_bvh(tscene.pack.bvh, o_t, d_t, tm)
    assert occ.dtype == torch.bool and torch.equal(occ, idx >= 0)
    assert 0.0 < float(occ.float().mean()) < 1.0
    j_occ = np.asarray(jbvh.occluded_bvh(jscene.pack.bvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    assert (occ.numpy() == j_occ).mean() >= 0.999


@pytest.mark.parametrize("mixed", [False, True])
def test_matches_the_brute_scan(scenes, mixed):
    """Tolerance (c): the walk and the soup scan over the same triangles."""
    tscene = scenes[mixed][1]
    brute = array_scene(theia_tpu_torch, "brute", mixed=mixed, device="cpu")
    o, d = (torch.as_tensor(a) for a in uniform_rays(N_RAYS, 6 + mixed))
    t, idx, _ = taccel._nearest(tscene.pack, o, d, torch.inf)
    tb, ib, _ = taccel._nearest(brute.pack, o, d, torch.inf)
    assert torch.equal(idx >= 0, ib >= 0) and bool((ib >= 0).any())
    same = idx == ib
    assert float(same.float().mean()) >= 0.999
    assert torch.equal(t[same], tb[same])
    # and is_visible takes the any-hit walk to the brute any-hit's answer
    target = o + 3.0 * d
    assert torch.equal(taccel.is_visible(tscene.pack, o, target), taccel.is_visible(brute.pack, o, target))


@pytest.mark.parametrize("kind", TIE_KINDS)
def test_tie_scenes_match_jax_and_brute(kind):
    """Tolerance (f): exact ties inside a leaf (duplicated rows) and
    across leaves (coincident instances)."""
    tscene = tie_scene(theia_tpu_torch, "bvh", kind, device="cpu")
    brute = tie_scene(theia_tpu_torch, "brute", kind, device="cpu")
    jscene = tie_scene(theia_tpu, "bvh", kind)
    o, d, t_max = array_rays(N_RAYS, 22, n_side=2)
    o_t, d_t, tm = (torch.as_tensor(a) for a in (o, d, t_max))
    t, idx = tbvh.nearest_triangle_bvh(tscene.pack.bvh, o_t, d_t, torch.inf)
    jt, jidx = jbvh.nearest_triangle_bvh(jscene.pack.bvh, jnp.asarray(o), jnp.asarray(d), jnp.inf)
    assert_winners_match(t, idx, jt, jidx)
    tb, ib, _ = taccel._nearest(brute.pack, o_t, d_t, torch.inf)
    assert torch.equal(idx >= 0, ib >= 0) and bool((ib >= 0).any())
    same = idx == ib
    assert float(same.float().mean()) >= 0.999 and torch.equal(t[same], tb[same])
    occ = tbvh.occluded_bvh(tscene.pack.bvh, o_t, d_t, tm)
    _, idx_tm = tbvh.nearest_triangle_bvh(tscene.pack.bvh, o_t, d_t, tm)
    assert torch.equal(occ, idx_tm >= 0) and 0.0 < float(occ.float().mean()) < 1.0


def test_translate_instance_raises():
    """As ``theia_tpu/scene.py:357-361``: a BVH bakes world geometry."""
    pack = array_scene(theia_tpu_torch, "bvh", n_side=2, device="cpu").pack
    with pytest.raises(ValueError, match="brute"):
        pack.translate_instance(0, torch.zeros(3))


def test_traced_batch_matches_jax():
    """Tolerance (e): the flagship scene tracer (path length 10, guided,
    icosphere(2) spheres) on ``accel="bvh"`` in both packages; the MIS
    shadow rays take the full nearest-hit walk, as in ``theia_tpu``."""
    batch, path = 2048, 10
    jt = build_flagship(theia_tpu, icosphere(2), batch, path, accel="bvh")
    jt._debug_rng = True
    p = jt.params()
    j_state, _, j_dims = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    j_hist = np.asarray(jt.response.result(p["response"], j_state), np.float64)
    tt = build_flagship(theia_tpu_torch, icosphere(2), batch, path, accel="bvh", device="cpu")
    assert tt.scene.pack.bvh is not None and tt.scene.leaf_size == 8
    tt._debug_rng = True
    tp = tt.params()
    with torch.no_grad():
        t_state, _, t_dims = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    t_hist = tt.response.result(tp["response"], t_state).numpy().astype(np.float64)
    assert (t_dims.numpy() == np.asarray(j_dims)).mean() >= 0.995
    assert j_hist.sum() > 0.0
    assert abs(t_hist.sum() / j_hist.sum() - 1.0) <= 1e-3
    assert np.abs(t_hist - j_hist).sum() / j_hist.sum() <= 1e-2
