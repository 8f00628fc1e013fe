"""The soup table's layout (Morton order in each group, sub-boxes of 32
rows, the index in every row), the soup kernels' first rejection test
through its plain twin, the shadow pair in one query (``target_in_table``),
and the port's repairs around them: ``chunk=`` accepted everywhere,
``interop`` refusing packs it cannot carry, ``translate_instance``'s
gradient.

Tolerances and why:
(a) The new table against the first soup kernels' layout (the soup's own
    order, the chunk rule alone, each chunk's index from its first row),
    rebuilt here from the soup's rows: t and idx bit for bit. Both run the
    same exact test on the same pairs; the layout only decides which pairs
    are skipped, and a skipped pair can never be hit (the boxes' margins),
    while ties go to the lowest row either way.
(b) The rejection twin: no pair that the exact test accepts may be
    dropped, with products rounded once and twice, for rays from the
    scene and from 50 to 2000 m away (where the shadow rays of the
    flagship start) and for drawn soups from 1e-3 to 1e3 in size; the
    query with the twin and ``reject`` in front of the exact test equals
    the plain query bit for bit.
(c) ``target_in_table`` against the composition it replaces (nearest hit,
    then any-hit bounded by it, then the masks): bit for bit.
(d) ``chunk=``: bit for bit with and without it.
(e) ``translate_instance``'s gradient against ``jax.grad`` through
    ``theia_tpu``: d(sum of the histogram)/d(delta) of a polarized batch of
    2048 lanes, path length 3, with the detector moved: each component
    within rtol 1e-5, the forward sum as tests/test_torch_brute.py holds
    it (measured: 4.8e-7 and 1.5e-7). The gradient sums the derivatives
    of every hit's distance and normal in another order than JAX, and
    carries the ulp-level differences of t between the packages (JAX
    divides, the port takes a reciprocal and a Newton step).
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
import theia_tpu_torch.accel as taccel
from theia_tpu_torch.interop import params_from_numpy
from theia_tpu_torch.ops import intersect_mt as tmt
from theia_tpu_torch.ops import intersect_soup as tsoup
from torch_flagship import adversarial_rays, build_flagship, icosphere, numpy_tree

torch.set_num_threads(1)

N_RAYS = 2048


@pytest.fixture(scope="module")
def flagship_pack():
    return build_flagship(theia_tpu_torch, icosphere(3), 64, 2, accel="brute", device="cpu").scene.pack


def _aimed(n, seed, far=False):
    """Rays half aimed at the flagship's spheres; with ``far`` from 50 to
    2000 m away, as the shadow rays of scatter vertices start."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 5.0, (n, 3))
    if far:
        u = rng.normal(size=(n, 3))
        o = u / np.linalg.norm(u, axis=1, keepdims=True) * rng.uniform(50.0, 2000.0, (n, 1))
    centers = np.asarray([[3.0, 0.0, 0.0], [0.0, 3.0, 0.0]])[rng.integers(0, 2, n)]
    d = rng.normal(size=(n, 3))
    aim = centers + rng.normal(scale=0.4, size=(n, 3)) - o
    d = np.where(rng.uniform(size=(n, 1)) < (0.9 if far else 0.5), aim, d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.where(rng.uniform(size=n) < 0.5, np.inf, rng.uniform(0.5, 2500.0, n))
    return tuple(torch.as_tensor(a.astype(np.float32)) for a in (o, d, t))


def _first_layout(table: tsoup.SoupTable, rays, groups=None, active=None, any_hit=False):
    """The first soup kernels' plain walk: the soup's own order, the chunk
    rule alone, a chunk's rows reporting its first row's index plus their
    place."""
    first = tsoup.SoupTable(*table.soup, table.spans, np.arange(table.n_tri))
    assert (first.aos[:, tsoup.INDEX_COLUMN].view(torch.int32) == first.index).all()
    return tmt.chunk_walk(
        first.n_tri, first.chunk_box, *rays, tsoup._pair_test(first), visits=first.visits(groups),
        active=active, any_hit=any_hit,
    )


# -- (a) the layout ---------------------------------------------------------


@pytest.mark.parametrize("rays", ["scene", "far", "adversarial"])
@pytest.mark.parametrize("groups", [None, [2], [0, 1]])
def test_layout_equals_first_layout(flagship_pack, rays, groups):
    table = flagship_pack.soup
    if rays == "adversarial":
        soup = (a.numpy() for a in table.soup)
        o, d = adversarial_rays(*soup, seed=5, per_kind=24)
        r = (torch.as_tensor(o), torch.as_tensor(d), torch.full((o.shape[0],), torch.inf))
    else:
        r = _aimed(N_RAYS, 7 + len(rays), far=rays == "far")
    active = torch.as_tensor(np.random.default_rng(8).uniform(size=r[0].shape[0]) < 0.7)
    for mask in (None, active):
        got = tsoup.nearest_in_table(table, *r, groups=groups, active=mask)
        want = _first_layout(table, r, groups, mask)
        assert (want[1] >= 0).float().mean() > 0.02
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # the bound at each lane's hit, and the any-hit
        t_hit = torch.where(got[1] >= 0, got[0], r[2])
        for bound in (r[2], t_hit, torch.nextafter(t_hit, torch.tensor(torch.inf))):
            rb = (r[0], r[1], bound.contiguous())
            occ = tsoup.anyhit_in_table(table, *rb, groups=groups, active=mask)
            assert torch.equal(occ, _first_layout(table, rb, groups, mask, any_hit=True))


def test_layout_keeps_groups_and_the_lowest_row_on_ties(flagship_pack):
    """Morton order stays inside each group; the index column holds each
    row's soup row; a triangle that appears twice, in two groups, answers
    with its lower row whichever chunk comes first."""
    v0, e1, e2 = flagship_pack.soup.soup
    dup = slice(2560, 2560 + 300)  # part of the detector, again as a group of its own
    soup = [torch.cat([a, a[dup]]) for a in (v0, e1, e2)]
    spans = ((0, 1280), (1280, 2560), (2560, 3840), (3840, 4140))
    table = tsoup.SoupTable(*soup, spans)
    for k, (s, e) in enumerate(spans):
        c0, c1 = table.group_chunks[k]
        idx = table.index[c0 * tsoup.CHUNK : c1 * tsoup.CHUNK]
        assert sorted(set(idx.tolist())) == list(range(s, e))
        assert table.order[s:e].tolist() != list(range(s, e))  # really reordered
    assert torch.equal(table.aos[:, tsoup.INDEX_COLUMN].view(torch.int32), table.index)
    assert table.sub_box.shape == (table.n_chunks * tsoup.CHUNK // tsoup.SUB, 8)
    o, d, _ = _aimed(N_RAYS, 11)
    for groups in ([2, 3], [3, 2], None):
        t, idx = tsoup.nearest_in_table(table, o, d, torch.inf, groups=groups)
        assert (idx >= 0).any() and not ((idx >= 3840) & (idx < 4140)).any()
        solo_t, solo_i = tsoup.nearest_in_table(table, o, d, torch.inf, groups=[3])
        # where the copy is hit first, its original (1280 rows lower) is hit at the same t and wins
        hit_copy = (solo_i >= 0) & (solo_t == t)
        assert hit_copy.any() and torch.equal(idx[hit_copy], solo_i[hit_copy] - 1280)
    # an order that moves a row out of its group is refused
    bad = np.arange(table.n_tri)
    bad[[0, 1280]] = bad[[1280, 0]]
    with pytest.raises(ValueError, match="order"):
        tsoup.SoupTable(*soup, spans, bad)


def test_translate_instance_keeps_the_order(flagship_pack):
    moved = flagship_pack.translate_instance(2, np.asarray([0.3, -0.2, 0.1], np.float32))
    assert np.array_equal(moved.soup.order, flagship_pack.soup.order)
    fresh = tsoup.SoupTable(moved.w_v0, moved.w_e1, moved.w_e2, moved.soup.spans, moved.soup.order)
    assert torch.equal(moved.soup.aos, fresh.aos) and torch.equal(moved.soup.sub_box, fresh.sub_box)


# -- (b) the first rejection test --------------------------------------------


def _exact_and_dropped(table, o, d, fused):
    hit = torch.cat([
        tmt._mt_exact_plain(table.rows[:, c0 : c0 + tsoup.CHUNK], o, d)[1]
        for c0 in range(0, table.n_chunks * tsoup.CHUNK, tsoup.CHUNK)
    ], dim=1)
    dropped = tmt._mt_sphere_miss_plain(table.aos, table.sub_box, o, d, fused)
    real = torch.cat([torch.arange(tsoup.CHUNK) < c for _, _, c in table.visits()])
    return hit[:, real], dropped[:, real]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rays", ["scene", "far", "adversarial"])
def test_sphere_twin_drops_no_hit(flagship_pack, rays, fused):
    table = flagship_pack.soup
    if rays == "adversarial":
        o, d = adversarial_rays(*(a.numpy() for a in table.soup), seed=9, per_kind=16)
        o, d = torch.as_tensor(o), torch.as_tensor(d)
    else:
        o, d, _ = _aimed(512, 12 + len(rays), far=rays == "far")
    hit, dropped = _exact_and_dropped(table, o, d, fused)
    assert hit.any(dim=1).float().mean() > 0.2
    assert not (hit & dropped).any(), torch.nonzero(hit & dropped)[:5].tolist()
    # and it drops nearly every pair from the scene (from far away the guard, which grows with the
    # distance because the exact test's rounding does, lets the pairs near a silhouette through)
    if rays == "scene":
        assert dropped.float().mean() > 0.9


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), exponent=st.integers(-3, 3), far=st.booleans())
def test_sphere_twin_on_drawn_soups(seed, exponent, far):
    """Soups of 40 triangles of size ~scale, some degenerate or tiny, and
    rays aimed at their vertices, edges and interiors from ~10 or ~1e4
    sizes away."""
    rng = np.random.default_rng(seed)
    scale = 10.0**exponent
    v0 = rng.normal(scale=10.0 * scale, size=(40, 3))
    e1 = rng.normal(scale=scale, size=(40, 3))
    e2 = rng.normal(scale=scale, size=(40, 3))
    e2[0::8] = 2.0 * e1[0::8]
    e2[1::8] = 2.0 * e1[1::8] + 1e-6 * e2[1::8]
    table = tsoup.SoupTable(*(torch.as_tensor(a.astype(np.float32)) for a in (v0, e1, e2)))
    i = rng.integers(0, 40, 96)
    w = rng.choice([0.0, 1.0, 0.5, -1e-6, 1.0 + 1e-6, 0.25], size=(96, 2))
    target = v0[i] + w[:, :1] * e1[i] + w[:, 1:] * e2[i]
    o = rng.normal(scale=(1e4 if far else 10.0) * scale, size=(96, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0::7] *= rng.choice([1e-3, 7.0, 1e4])
    o, d = torch.as_tensor(o.astype(np.float32)), torch.as_tensor(d.astype(np.float32))
    for fused in (True, False):
        hit, dropped = _exact_and_dropped(table, o, d, fused)
        assert not (hit & dropped).any()


def test_filtered_walk_equals_plain(flagship_pack):
    """The query as the kernels run it (sub-boxes, the twin and reject()
    in front of the exact test) against the plain query, bit for bit, with
    bounds at, just below and just above each ray's hit."""
    table = flagship_pack.soup
    o = torch.cat([_aimed(768, 21)[0], _aimed(768, 22, far=True)[0]])
    d = torch.cat([_aimed(768, 21)[1], _aimed(768, 22, far=True)[1]])

    def pair_test(oo, dd, c0):
        t, hit = tmt._mt_exact_plain(table.rows[:, c0 : c0 + tsoup.CHUNK], oo, dd)
        rejected = tmt._mt_sphere_miss_plain(*tmt.chunk_tables(table.aos, table.sub_box, c0), oo, dd)
        rejected |= tmt._mt_reject_plain(table.aos[c0 : c0 + tsoup.CHUNK], oo, dd)
        return t, hit & ~rejected

    t_hit, _ = tsoup.nearest_in_table(table, o, d, torch.inf)
    assert torch.isfinite(t_hit).float().mean() > 0.3
    inf = torch.tensor(torch.inf)
    for t_max in (torch.full_like(t_hit, torch.inf), t_hit, torch.nextafter(t_hit, inf), torch.nextafter(t_hit, -inf)):
        want = tsoup.nearest_in_table(table, o, d, t_max)
        got = tmt.chunk_walk(
            table.n_tri, table.chunk_box, o, d, t_max, pair_test, visits=table.visits(), index=table.index,
            sub_box=table.sub_box,
        )
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- (c) the shadow pair in one query ----------------------------------------


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_target_equals_composition(flagship_pack, rows, masked):
    table, tri_data = flagship_pack.soup, flagship_pack.tri_data
    o, d, t = _aimed(N_RAYS, 30)
    o[::2] = o[::2] * 0.3  # from between the spheres too
    active = torch.as_tensor(np.random.default_rng(31).uniform(size=N_RAYS) < 0.7) if masked else None
    got = tsoup.target_in_table(
        table, o, d, t, groups=[2], occluders=[0, 1], active=active, rows_table=tri_data if rows else None
    )
    t_det, i_det, r_det = tsoup.nearest_in_table_rows(table, tri_data, o, d, t, groups=[2], active=active)
    found = i_det >= 0
    occluded = tsoup.anyhit_in_table(table, o, d, t_det, groups=[0, 1], active=found)
    valid = found & ~occluded
    want = (torch.where(valid, t_det, torch.inf), torch.where(valid, i_det, -1),
            torch.where(valid[:, None], r_det, tri_data[0]))
    assert len(got) == (3 if rows else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert valid.any() and (found & occluded).any()
    if masked:
        assert not valid[~active].any()
    # no detector: every lane misses; no occluder: the nearest hit alone
    none = tsoup.target_in_table(table, o, d, t, groups=[], occluders=[0, 1, 2], active=active)
    assert torch.isinf(none[0]).all() and (none[1] == -1).all()
    alone = tsoup.target_in_table(table, o, d, t, groups=[2], occluders=[], active=active)
    assert torch.equal(alone[1], i_det) and torch.equal(alone[0], t_det)


def test_cpu_queries_launch_no_kernel():
    assert tsoup.target_in_table.launches == 0


# -- (d) chunk= ---------------------------------------------------------------


def _chunk_calls(pack):
    o, d, t = _aimed(512, 40)
    med = torch.zeros(512, dtype=torch.int32)
    soup = (pack.w_v0, pack.w_e1, pack.w_e2)
    target = o + d * 2.0
    return {
        "nearest_in_soup": lambda **kw: tsoup.nearest_in_soup(*soup, o, d, t, **kw),
        "anyhit_in_soup": lambda **kw: (tsoup.anyhit_in_soup(*soup, o, d, t, **kw),),
        "nearest_culled": lambda **kw: taccel.nearest_culled(pack, o, d, t, **kw, groups=[2]),
        "anyhit_culled": lambda **kw: (taccel.anyhit_culled(pack, o, d, t, **kw, active=t > 100.0),),
        "intersect_scene": lambda **kw: dataclasses.astuple(taccel.intersect_scene(pack, med, o, d, t, **kw)),
        "intersect_target": lambda **kw: dataclasses.astuple(
            taccel.intersect_target(pack, med, o, d, t, **kw, active=t > 100.0)
        ),
        "is_visible": lambda **kw: (taccel.is_visible(pack, o, target, **kw),),
    }


@pytest.mark.parametrize("name", [
    "nearest_in_soup", "anyhit_in_soup", "nearest_culled", "anyhit_culled", "intersect_scene", "intersect_target",
    "is_visible",
])
def test_chunk_keyword_is_accepted_and_ignored(flagship_pack, name):
    call = _chunk_calls(flagship_pack)[name]
    want = call()
    for chunk in (4096, 256):
        for g, w in zip(call(chunk=chunk), want):
            assert torch.equal(g, w)
    # positionally too, where theia_tpu takes it so
    if name in ("nearest_in_soup", "anyhit_in_soup"):
        pack = flagship_pack
        got = getattr(tsoup, name)(pack.w_v0, pack.w_e1, pack.w_e2, *_aimed(512, 40), 4096)
        for g, w in zip(got if name == "nearest_in_soup" else (got,), want):
            assert torch.equal(g, w)


# -- interop refuses packs it cannot carry ------------------------------------


def _jax_scene_tree(accel):
    mesh = icosphere(2)
    tracer = build_flagship(theia_tpu, mesh, 64, 2, accel="brute")
    tree = numpy_tree(tracer.params())
    if accel == "brute":
        return tree
    try:
        jt = build_flagship(theia_tpu, mesh, 64, 2, accel=accel)
        return numpy_tree(jt.params())
    except Exception:  # theia_tpu's native BVH builder is not available: a brute tree with the accel's entry
        tree["scene"] = dict(tree["scene"], **{accel: {"nodes": np.zeros((1, 8), np.float32)}})
        return tree


def test_interop_carries_a_brute_pack():
    tree = _jax_scene_tree("brute")
    pack = params_from_numpy(tree, "cpu")["scene"]
    assert pack.soup is not None and pack.mt is None and pack.woop is None
    assert pack.soup_is_det == (False, False, True)


@pytest.mark.parametrize("accel", ["bvh", "instanced"])
def test_interop_refuses_bvh_and_instanced_packs(accel):
    tree = _jax_scene_tree(accel)
    assert accel in tree["scene"]
    with pytest.raises(NotImplementedError, match=accel):
        params_from_numpy(tree, "cpu")


# -- (e) translate_instance's gradient -----------------------------------------

GRAD_BATCH = 2048
GRAD_PATH = 3
DELTA = (0.05, -0.04, 0.03)


def _patched(p, pack):
    pp = dict(p)
    pp["scene"] = pack
    return pp


def test_translate_instance_gradient_matches_jax():
    mesh = icosphere(3)
    jt = build_flagship(theia_tpu, mesh, GRAD_BATCH, GRAD_PATH, accel="brute", polarized=True)
    fn, (p, counter, streams) = jt.trace_fn()

    def j_loss(delta):
        state, _ = fn(_patched(p, p["scene"].translate_instance(2, delta)), counter, streams)
        return jnp.sum(state)

    j_value, j_grad = jax.jit(jax.value_and_grad(j_loss))(jnp.asarray(DELTA, jnp.float32))

    tt = build_flagship(theia_tpu_torch, mesh, GRAD_BATCH, GRAD_PATH, accel="brute", device="cpu", polarized=True)
    tfn, (tp, tcounter, tstreams) = tt.trace_fn()
    delta = torch.tensor(DELTA, dtype=torch.float32, requires_grad=True)
    moved = tp["scene"].translate_instance(2, delta)
    assert moved.tri_data.requires_grad and not moved.soup.aos.requires_grad
    state, _ = tfn(_patched(tp, moved), tcounter, tstreams)
    state.sum().backward()
    t_grad = delta.grad.numpy()
    np.testing.assert_allclose(float(state.sum()), float(j_value), rtol=1e-5)
    assert np.isfinite(t_grad).all() and np.abs(t_grad).max() > 0.0
    np.testing.assert_allclose(t_grad, np.asarray(j_grad), rtol=1e-5)
