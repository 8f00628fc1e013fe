"""The two rejection tests that the nearest-hit kernels run in front of
their exact tests (the bounding-sphere test of ``csrc/nearest_scan.cuh``
from where a ray enters a sub-box, then the division-free test of
``csrc/moller_trumbore.cuh`` and ``csrc/intersect_woop.cu``), through
their plain PyTorch twins (``_mt_sphere_miss_plain`` and
``_mt_reject_plain``, ``_woop_sphere_miss_plain`` and
``_woop_reject_plain``: the same formulas and slack), held against the
exact plain tests.

The one property that bit-equality of the kernels rests on: **no pair
that the exact test accepts is rejected**. It is checked with the
products rounded once (as the kernels' fmaf rounds them, emulated through
float64) and twice (separate multiply and add), since the slack has to
cover either, over

- seeded rays against the flagship's 3840 icosphere triangles,
- adversarial rays: through vertices, along edges, in a triangle's
  plane, from origins pushed off a surface by ``offset_ray``,
- hypothesis-drawn soups at scales from 1e-3 to 1e3 with degenerate,
  near-degenerate (|det| around 1e-12) and huge triangles, rays aimed at
  vertices, edges and interiors, unnormalised and non-finite rays,

and, for the query as a whole, a walk that applies the rejection test in
front of the exact test must return bit for bit what the plain version
returns, with t_max at, just below and just above the hit distance.
The share of pairs that survive both rejection tests on the flagship is
asserted below 1 % (measured 0.032 % for MT and 0.033 % for Woop on the
seeded rays)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import theia_tpu_torch
from theia_tpu_torch.ops import intersect_mt as tmt
from theia_tpu_torch.ops import intersect_woop as twoop
from torch_flagship import adversarial_rays, build_flagship, icosphere

torch.set_num_threads(1)

KINDS = ("mt", "woop")


def _pack(kind, v0, e1, e2):
    pack = tmt.pack_mt if kind == "mt" else twoop.pack_woop
    return pack(*(np.asarray(a, np.float32) for a in (v0, e1, e2)), device="cpu")


def _twins(kind):
    if kind == "mt":
        return tmt._mt_sphere_miss_plain, tmt._mt_reject_plain
    return twoop._woop_sphere_miss_plain, twoop._woop_reject_plain


def _rejected(kind, aos, sub_box, o, d, fused=True):
    """Both rejection twins on the rows ``aos`` (whole sub-boxes from the
    first, each bounded by its row of ``sub_box``): bool (rays, rows)."""
    sphere_miss, reject = _twins(kind)
    return sphere_miss(aos, sub_box, o, d, fused) | reject(aos, o, d, fused)


def _exact_and_reject(kind, pack, o, d, fused):
    """(hit, reject), each (rays, n_tri): the exact plain test and the
    rejection twins on every pair."""
    o, d = torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)
    reject = _rejected(kind, pack.tri_aos, pack.sub_box, o, d, fused)[:, : pack.n_tri]
    if kind == "mt":
        _, hit = tmt._mt_exact_plain(tmt._rows(pack.tri, pack.n_tri), o, d)
    else:
        _, hit = twoop._woop_exact_plain(twoop._transforms(pack.b, pack.n_tri), o, d)
    return hit, reject


def _assert_no_false_reject(kind, pack, o, d):
    shares = []
    for fused in (True, False):
        hit, reject = _exact_and_reject(kind, pack, o, d, fused)
        bad = hit & reject
        assert not bad.any(), (kind, fused, torch.nonzero(bad)[:5].tolist())
        shares.append(1.0 - reject.float().mean().item())
    return hit, shares[0]


@pytest.fixture(scope="module")
def flagship():
    mesh = icosphere(3)
    rows = build_flagship(theia_tpu_torch, mesh, 64, 2, device="cpu").scene.pack.tri_data.numpy()
    soup = rows[:, 18:21], rows[:, 21:24], rows[:, 24:27]
    return soup, {kind: _pack(kind, *soup) for kind in KINDS}


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.0, -1.0, -1.0], [4.5, 4.0, 1.0], size=(n, 3))
    centers = np.asarray([[3.0, 0.0, 0.0], [0.0, 3.0, 0.0]])[rng.integers(0, 2, n)]
    aim = centers + rng.normal(scale=0.5, size=(n, 3))
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim - o, rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_flagship_random_rays(flagship, kind, record_property):
    _, packs = flagship
    o, d = _random_rays(1024, 21)
    hit, share = _assert_no_false_reject(kind, packs[kind], o, d)
    assert hit.any(dim=1).float().mean() > 0.2  # the rays really hit
    record_property("survivor_share", share)
    print(f"{kind}: {share:.5f} of the pairs survive the rejection test")
    assert share < 0.01, share


@pytest.mark.parametrize("kind", KINDS)
def test_flagship_adversarial_rays(flagship, kind):
    soup, packs = flagship
    o, d = adversarial_rays(*soup, seed=22)
    hit, share = _assert_no_false_reject(kind, packs[kind], o, d)
    assert hit.any(dim=1).float().mean() > 0.5
    assert share < 0.02, share


def _drawn_soup(rng, scale, n_tri=48):
    """Triangles of size ~scale around points of size ~10*scale, some
    degenerate (e2 parallel to e1, exactly and nearly), some tiny (|det|
    around the exact test's 1e-12 cutoff), one huge."""
    v0 = rng.normal(scale=10.0 * scale, size=(n_tri, 3))
    e1 = rng.normal(scale=scale, size=(n_tri, 3))
    e2 = rng.normal(scale=scale, size=(n_tri, 3))
    e2[0::8] = 2.0 * e1[0::8]
    e2[1::8] = 2.0 * e1[1::8] + 1e-6 * e2[1::8]
    tiny = 1e-4 / max(scale, 1e-3)  # |e1 x e2| ~ 1e-8 * ..., det near 1e-12
    e1[2::8] *= tiny
    e2[2::8] *= tiny
    e1[3] *= 1e12 / scale
    return v0, e1, e2


def _drawn_rays(rng, v0, e1, e2, scale, n=64):
    i = rng.integers(0, v0.shape[0], n)
    # barycentric targets on vertices, edges, just outside and inside
    w = rng.choice([0.0, 1.0, 0.5, -1e-6, 1.0 + 1e-6, 0.25], size=(n, 2))
    w[:, 1] = np.where(rng.uniform(size=n) < 0.5, w[:, 1], 1.0 - w[:, 0])
    target = v0[i] + w[:, :1] * e1[i] + w[:, 1:] * e2[i]
    o = rng.normal(scale=10.0 * scale, size=(n, 3))
    d = target - o
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    d[0::7] *= rng.choice([1e-3, 7.0, 1e4])  # unnormalised directions
    o[1], d[2], o[3] = np.nan, np.inf, 3e38  # rays the kernel must hand on
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), exponent=st.integers(-3, 3))
def test_drawn_soups(kind, seed, exponent):
    rng = np.random.default_rng(seed)
    scale = 10.0**exponent
    soup = _drawn_soup(rng, scale)
    pack = _pack(kind, *soup)
    o, d = _drawn_rays(rng, *soup, scale)
    _assert_no_false_reject(kind, pack, o, d)
    o, d = adversarial_rays(*soup, seed=seed, per_kind=8)
    _assert_no_false_reject(kind, pack, o, d)


@pytest.mark.parametrize("kind", KINDS)
def test_filtered_walk_equals_plain(flagship, kind):
    """The query with the rejection test in front of the exact test, as the
    kernel runs it, against the plain version, with t_max set around each
    ray's own hit distance (a hit counts only if strictly closer)."""
    soup, packs = flagship
    pack = packs[kind]
    o_r, d_r = _random_rays(768, 23)
    o_a, d_a = adversarial_rays(*soup, seed=24, per_kind=32)
    o = torch.as_tensor(np.concatenate([o_r, o_a]))
    d = torch.as_tensor(np.concatenate([d_r, d_a]))
    if kind == "mt":
        plain, cols, exact = tmt.nearest_triangle_mt_plain, tmt._rows(pack.tri, pack.n_tri), tmt._mt_exact_plain
    else:
        plain, cols = twoop.nearest_triangle_woop_plain, twoop._transforms(pack.b, pack.n_tri)
        exact = twoop._woop_exact_plain

    def pair_test(oo, dd, c0):
        t, hit = exact(cols[:, c0 : c0 + tmt.CHUNK], oo, dd)
        rejected = _rejected(kind, *tmt.chunk_tables(pack.tri_aos, pack.sub_box, c0), oo, dd)
        return t, hit & ~rejected[:, : hit.shape[1]]

    t_hit, _ = plain(pack, o, d, torch.full((o.shape[0],), torch.inf))
    assert torch.isfinite(t_hit).float().mean() > 0.3
    inf = torch.tensor(torch.inf)
    for t_max in (
        torch.full_like(t_hit, torch.inf),
        t_hit,  # at the hit: that hit no longer counts
        torch.nextafter(t_hit, inf),
        torch.nextafter(t_hit, -inf),
    ):
        want = plain(pack, o, d, t_max)
        got = tmt.chunk_walk(pack.n_tri, pack.chunk_box, o, d, t_max, pair_test, sub_box=pack.sub_box)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    stats = {}
    plain(pack, o, d, t_hit, stats)
    assert 0 < stats["pairs"] <= o.shape[0] * pack.n_tri
