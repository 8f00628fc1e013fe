"""The brute-force scene path of the port (``Scene(accel="auto")`` /
``"brute"``: the soup queries, ``ShadowSplit``, ``CullTables``, the split
``intersect_target``) against the live ``theia_tpu`` functions on the CPU,
on meshes built in code.

Tolerances and why:
(a) The scene tables are built by the same numpy code: equal bit for bit.
(b) Soup queries. ``theia_tpu`` divides by det; the port's exact test
    takes a correctly rounded reciprocal and one Newton step, and XLA's
    CPU code rounds the dot products of the test another way than the
    separate float32 operations do, so t differs by ulps: the median
    hit by 1, 90 % of the hits within T_ULPS = 4 (measured 3 at most over
    this file's cases), and grazing hits by more, without bound as a ray
    nears a triangle's plane and e2 . q cancels (measured 2120 ulp,
    1.46e-4 relative, among rays sent at one triangle from all sides,
    where the 99th percentile is 28 ulp; limit 3e-4 relative on every
    lane). 4 ulp on every lane does not hold;
    tests/test_torch_intersect_mt.py measured 2.4e-6 relative on the
    same scan with rays that graze less. The any-hit bounds set beside a
    hit stand BESIDE_ULPS = 16 times 2 to 8 steps off it, past that 99th
    percentile.
    idx is equal except where two hits lie that close to each
    other (a ray through a shared edge), on at most 0.1 % of lanes.
    Any-hit flags are equal except where a hit's t is that close to the
    bound; with the bound put exactly at the nearest hit the port
    reports "not occluded" (the one exact test: the winner cannot occlude
    itself).
(c) The culled queries against the port's own scan over the whole soup:
    bit-equal (``theia_tpu`` pins the same of its culling).
(d) ``SurfaceHit``: validity flips on at most 0.1 % of lanes; integer
    fields equal and float fields within 1e-5 on all but 0.1 % of the
    lanes both call valid (a tie picks the neighbouring face).
(e) The slice as a whole, as tests/test_torch_scene_tracer.py: RNG dims
    equal on >= 99.5 % of lanes, histogram sum rtol 1e-5, per-bin L1 at
    most 1 %; the gradient as tests/test_torch_grad.py: each entry rtol
    1e-3, sum rtol 1e-5.
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
import theia_tpu.accel as jaccel
import theia_tpu_torch
import theia_tpu_torch.accel as taccel
from theia_tpu_torch.interop import params_from_numpy
from theia_tpu_torch.ops import intersect_soup as tsoup
from torch_flagship import build_flagship, icosphere, numpy_tree

# the suite runs several xdist workers on one shared CPU: torch's intra-op
# threads in each of them oversubscribe it
torch.set_num_threads(1)

CHUNK = 256
N_RAYS = 4096
T_ULPS = 4
T_RTOL = 3e-4
BESIDE_ULPS = 16


def _t_close(got, want) -> bool:
    """Tolerance (b) of the module docstring on hit distances."""
    steps = _ulps(got, want)
    if steps.size == 0:
        return True
    return np.percentile(steps, 90) <= T_ULPS and np.allclose(got, want, rtol=T_RTOL, atol=0.0)


def _scene(pkg, kind: str, cull: bool = True, accel: str = "brute"):
    """Spheres of 320 triangles (not a multiple of the kernels' chunk of
    256): ``three`` = two occluders and one detector, ``array`` = two
    occluders and four detector modules, enough detector groups for
    ``theia_tpu``'s culled detector branch."""
    dev = {"device": "cpu"} if pkg is theia_tpu_torch else {}
    material, scene = pkg.material, pkg.scene
    mats = material.MaterialStore.pack(
        [material.Material("wall", None, None, flags="TR"), material.Material("det", None, None, flags="DB")],
        **dev,
    )
    meshes = scene.MeshStore({"sphere": pkg.mesh.Mesh.from_geometry(*icosphere(2))})
    T = scene.Transform
    walls = [((3.0, 0, 0), 0.8), ((0, 0, 2.0), 0.5)]
    dets = [(0.0, 3.0, 0.0)] if kind == "three" else [(0.0, 3.0, 0.0), (3.0, 3.0, 0.0), (-3.0, 3.0, 0.0), (0.0, 3.0, 3.0)]
    insts = [meshes.createInstance("sphere", "wall", T.TRS(scale=s, translate=p)) for p, s in walls]
    insts += [
        meshes.createInstance("sphere", "det", T.TRS(scale=0.6, translate=p), detectorId=i + 1)
        for i, p in enumerate(dets)
    ]
    return scene.Scene(insts, mats, medium=None, accel=accel, cull=cull, **dev)


@pytest.fixture(scope="module")
def packs():
    return {
        (kind, cull): (_scene(theia_tpu, kind, cull).pack, _scene(theia_tpu_torch, kind, cull).pack)
        for kind in ("three", "array") for cull in (True, False)
    }


@pytest.fixture(scope="module")
def flagship_soup():
    pack = build_flagship(theia_tpu_torch, icosphere(3), 64, 2, accel="brute", device="cpu").scene.pack
    return pack.w_v0.numpy(), pack.w_e1.numpy(), pack.w_e2.numpy()


def _rays(n, seed, unit=True):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if not unit:  # the soup queries take directions of any length
        d *= rng.uniform(0.2, 5.0, (n, 1))
    t = rng.uniform(0.1, 30.0, n).astype(np.float32)
    return o, d.astype(np.float32), t


def _aimed_rays(n, seed, unit=True):
    """Half of the rays aimed at the flagship's spheres, so many hit."""
    rng = np.random.default_rng(seed)
    o, d, t = _rays(n, seed, unit=True)
    centers = np.asarray([[3.0, 0.0, 0.0], [0.0, 3.0, 0.0]])[rng.integers(0, 2, n)]
    aim = centers + rng.normal(scale=0.4, size=(n, 3)) - o
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim, d)
    if not unit:
        d = d * rng.uniform(0.2, 5.0, (n, 1))
    return o, d.astype(np.float32), t


def _ulps(a, b):
    """Distance in float32 steps between positive finite values."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _tt(*arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays)


# -- the soup queries ------------------------------------------------------


def _sub_soup(soup, n_tri, o, d):
    """``n_tri`` triangles of the flagship's soup that the rays do hit:
    all of it, a run of the detector sphere, or for one triangle the one
    that most rays hit first."""
    if n_tri == 1:
        idx = tsoup.nearest_in_soup(*_tt(*soup, o, d), torch.inf)[1]
        start = int(torch.mode(idx[idx >= 0]).values)
    else:
        start = 0 if n_tri == 3840 else 2560
    sub = tuple(a[start : start + n_tri] for a in soup)
    if n_tri == 1:  # send every third ray at it, in place
        rng = np.random.default_rng(start)
        sel = np.arange(0, o.shape[0], 3)
        w = rng.dirichlet((1.0, 1.0, 1.0), size=sel.size)
        point = sub[0] + w[:, 1:2] * sub[1] + w[:, 2:3] * sub[2]
        d[sel] = ((point - o[sel]) * rng.uniform(0.2, 2.0, (sel.size, 1))).astype(np.float32)
    return sub


@pytest.mark.parametrize("n_tri", [1, 255, 257, 3840])
@pytest.mark.parametrize("t_max", ["scalar", "lanes"])
def test_nearest_in_soup_matches_jax(flagship_soup, n_tri, t_max):
    o, d, t = _aimed_rays(N_RAYS, n_tri, unit=False)
    v0, e1, e2 = _sub_soup(flagship_soup, n_tri, o, d)
    bound = np.float32(np.inf) if t_max == "scalar" else t
    jt, ji = jax.jit(lambda *a: jaccel.nearest_in_soup(*a, CHUNK))(v0, e1, e2, o, d, jnp.asarray(bound))
    jt, ji = np.asarray(jt), np.asarray(ji)
    tt, ti = tsoup.nearest_in_soup(*_tt(v0, e1, e2, o, d), torch.as_tensor(bound))
    tt, ti = tt.numpy(), ti.numpy()
    if n_tri > 1:
        assert (ji >= 0).mean() > 0.05  # the rays do hit
    differ = ti != ji
    assert differ.mean() <= 1e-3, differ.mean()
    both = (ti >= 0) & (ji >= 0)
    assert _t_close(tt[both], jt[both])  # ties included: the two hits lie that close
    miss = ti < 0
    assert np.isinf(tt[miss]).all() and (ti[miss] == -1).all()


def test_empty_soup(flagship_soup):
    v0, e1, e2 = (a[:0] for a in flagship_soup)
    o, d, t = _rays(100, 1)
    occ = tsoup.anyhit_in_soup(*_tt(v0, e1, e2, o, d, t))
    assert np.array_equal(occ.numpy(), np.asarray(jaccel.anyhit_in_soup(v0, e1, e2, o, d, t, CHUNK)))
    assert not occ.any()
    tt, ti = tsoup.nearest_in_soup(*_tt(v0, e1, e2, o, d, t))
    assert torch.isinf(tt).all() and (ti == -1).all()


@pytest.mark.parametrize("n_tri", [1, 255, 257, 3840])
def test_anyhit_in_soup_matches_jax(flagship_soup, n_tri):
    o, d, t = _aimed_rays(N_RAYS, 10 + n_tri, unit=False)
    v0, e1, e2 = _sub_soup(flagship_soup, n_tri, o, d)
    t_hit = tsoup.nearest_in_soup(*_tt(v0, e1, e2, o, d), torch.inf)[0].numpy()
    hit = np.isfinite(t_hit)
    # a quarter of the lanes random, a quarter at the hit, the rest 2 to 8 BESIDE_ULPS to either side of it
    kind = np.arange(N_RAYS) % 4
    steps = np.random.default_rng(n_tri).integers(2 * BESIDE_ULPS, 8 * BESIDE_ULPS, N_RAYS) * np.where(kind == 2, 1, -1)
    near = (t_hit.view(np.int32) + steps.astype(np.int32)).view(np.float32)
    bound = np.where(hit & (kind >= 2), near, np.where(hit & (kind == 1), t_hit, t)).astype(np.float32)
    jocc = np.asarray(jax.jit(lambda *a: jaccel.anyhit_in_soup(*a, CHUNK))(v0, e1, e2, o, d, bound))
    tocc = tsoup.anyhit_in_soup(*_tt(v0, e1, e2, o, d, bound)).numpy()
    at_hit = hit & (kind == 1)
    assert (tocc != jocc)[~at_hit].mean() <= 1e-3
    assert tocc[hit & (kind == 2)].mean() > 0.99 and tocc[hit & (kind == 3)].mean() < 0.01
    assert at_hit.sum() >= 3
    # the bound at the nearest hit: that hit does not occlude itself
    assert tocc[at_hit].mean() <= 1e-3
    # a scalar bound
    jocc = np.asarray(jaccel.anyhit_in_soup(v0, e1, e2, o, d, 4.0, CHUNK))
    tocc = tsoup.anyhit_in_soup(*_tt(v0, e1, e2, o, d), 4.0).numpy()
    close = hit & (_ulps(np.where(hit, t_hit, 1.0), np.float32(4.0)) <= T_ULPS)
    assert np.array_equal(tocc[~close], jocc[~close])


def test_soup_table_groups_and_padding(flagship_soup):
    """Groups that start and end anywhere, an empty one among them: the
    table pads each to whole chunks, and a query over some groups equals
    the query over a soup of just their triangles, with rows of the whole
    soup as indices; ``active`` takes lanes out."""
    v0, e1, e2 = _tt(*flagship_soup)
    spans = ((0, 100), (100, 100), (100, 1000), (1000, 2561), (2561, 3840))
    table = tsoup.SoupTable(v0, e1, e2, spans)
    assert table.n_chunks == 1 + 0 + 4 + 7 + 5
    assert table.chunk_count.tolist()[:5] == [100, 256, 256, 256, 132]
    assert table.chunk_first.tolist()[:6] == [0, 100, 356, 612, 868, 1000]
    # each group's rows in Morton order among themselves, every row carrying its soup row, padding
    # repeating the group's last row; a sub-box a run of 32 rows
    for k, (start, end) in enumerate(spans):
        c0, c1 = table.group_chunks[k]
        rows = table.index[c0 * CHUNK : c1 * CHUNK].tolist()
        real = end - start
        assert sorted(rows[:real]) == list(range(start, end)) and set(rows[real:]) <= {rows[real - 1] if real else None}
    assert torch.equal(table.aos[:, tsoup.INDEX_COLUMN].view(torch.int32), table.index)
    assert table.sub_box.shape == (table.n_chunks * CHUNK // tsoup.SUB, 8)
    o, d, t = _tt(*_aimed_rays(N_RAYS, 3))
    active = torch.as_tensor(np.random.default_rng(4).uniform(size=N_RAYS) < 0.6)
    for groups in ([0], [2, 4], [1], [0, 1, 2, 3, 4], None):
        rows = np.concatenate([np.arange(*spans[k]) for k in (range(5) if groups is None else groups)]).astype(np.int64)
        sub = tsoup.SoupTable(v0[rows], e1[rows], e2[rows])
        want_t, want_i = tsoup.nearest_in_table(sub, o, d, t)
        got_t, got_i = tsoup.nearest_in_table(table, o, d, t, groups=groups)
        assert torch.equal(got_t, want_t)
        want_rows = torch.where(want_i >= 0, torch.as_tensor(np.append(rows, 0))[want_i.long()], -1).to(torch.int32)
        assert torch.equal(got_i, want_rows)
        assert torch.equal(tsoup.anyhit_in_table(table, o, d, t, groups=groups), want_i >= 0)
        masked_t, masked_i = tsoup.nearest_in_table(table, o, d, t, groups=groups, active=active)
        assert torch.equal(masked_t, torch.where(active, got_t, torch.inf))
        assert torch.equal(masked_i, torch.where(active, got_i, -1))
        occ = tsoup.anyhit_in_table(table, o, d, t, groups=groups, active=active)
        assert torch.equal(occ, active & (got_i >= 0))
    rows32 = torch.arange(3840 * 32, dtype=torch.float32).reshape(3840, 32)
    got = tsoup.nearest_in_table_rows(table, rows32, o, d, t, groups=[2, 4], active=active)
    want = tsoup.nearest_in_table(table, o, d, t, groups=[2, 4], active=active)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], rows32[want[1].clamp_min(0).long()])
    with pytest.raises(ValueError, match="active"):
        tsoup.nearest_in_table(table, o, d, t, active=active[:-1])
    with pytest.raises(ValueError, match="float32"):
        tsoup.anyhit_in_table(table, o.double(), d, t)


def test_cpu_queries_launch_no_kernel():
    assert tsoup.nearest_in_table.launches == tsoup.nearest_in_table_rows.launches == 0
    assert tsoup.anyhit_in_table.launches == 0


# -- the sphere rule -------------------------------------------------------


def test_seg_hits_sphere_matches_jax(packs):
    jp, tp = packs["three", True]
    o, d, t = _aimed_rays(N_RAYS, 20, unit=False)
    for k in range(3):
        want = np.asarray(jaccel._seg_hits_sphere(o, d, t, jp.cull.centers[k], jp.cull.radii[k]))
        got = taccel._seg_hits_sphere(*_tt(o, d, t), tp.cull.centers[k], tp.cull.radii[k]).numpy()
        assert 0.005 < want.mean() < 0.98
        assert (got != want).mean() <= 1e-3  # the same float32 formula, summed in another order


finite = lambda lo, hi: st.floats(lo, hi, allow_nan=False, width=32)
vec3 = lambda lo, hi: st.tuples(finite(lo, hi), finite(lo, hi), finite(lo, hi))


@settings(max_examples=300, deadline=None)
@given(o=vec3(-50, 50), d=vec3(-4, 4), c=vec3(-50, 50), r=finite(2.0**-7, 10), t_max=finite(0.0, 200), s=finite(0, 1))
def test_seg_hits_sphere_is_conservative(o, d, c, r, t_max, s):
    """No segment that touches the sphere (decided in float64 at the
    point of the segment at parameter s * t_max, and at its closest
    approach) is reported as missing it; a tangent segment stays needed."""
    o64, d64, c64 = (np.asarray(v, np.float64) for v in (o, d, c))
    if not np.any(d64):
        return
    tc = np.clip(-np.dot(o64 - c64, d64) / np.dot(d64, d64), 0.0, t_max)
    touches = any(np.linalg.norm(o64 + tp * d64 - c64) <= r for tp in (tc, s * t_max))
    got = taccel._seg_hits_sphere(
        *(torch.tensor([v], dtype=torch.float32) for v in (o, d)), torch.tensor([t_max], dtype=torch.float32),
        torch.tensor(c, dtype=torch.float32), torch.tensor(r, dtype=torch.float32),
    )
    assert bool(got[0]) or not touches
    # tangent in the xy-plane at exactly the radius (theia_tpu's test_cull_conservative_slack)
    tangent = taccel._seg_hits_sphere(
        torch.tensor([[c[0] - 5.0, c[1] + r, c[2]]], dtype=torch.float32), torch.tensor([[1.0, 0.0, 0.0]]),
        torch.tensor([100.0]), torch.tensor(c, dtype=torch.float32), torch.tensor(r, dtype=torch.float32),
    )
    assert bool(tangent[0])


# -- the scene's tables ----------------------------------------------------


@pytest.mark.parametrize("kind", ["three", "array"])
@pytest.mark.parametrize("cull", [True, False])
def test_scene_tables_equal(packs, kind, cull):
    jp, tp = packs[kind, cull]
    for f in ("w_v0", "w_e1", "w_e2", "tri_data", "inst_data"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)), getattr(tp, f).numpy(), err_msg=f)
    assert tp.mt is None and tp.woop is None
    # instance order, not Morton order
    inst = tp.tri_data[:, 27].numpy()
    assert (np.diff(inst) >= 0).all()
    for f in dataclasses.fields(tp.shadow_split):
        np.testing.assert_array_equal(
            np.asarray(getattr(jp.shadow_split, f.name)), getattr(tp.shadow_split, f.name).numpy(), err_msg=f.name
        )
    n_inst = 3 if kind == "three" else 6
    assert tp.soup_is_det == (False, False) + (True,) * (n_inst - 2)
    assert tp.soup.spans == tuple((320 * k, 320 * (k + 1)) for k in range(n_inst))
    assert tp.soup.n_chunks == 2 * n_inst and tp.soup.chunk_count.tolist() == [256, 64] * n_inst
    if not cull:
        assert jp.cull is None and tp.cull is None
        return
    np.testing.assert_array_equal(np.asarray(jp.cull.centers), tp.cull.centers.numpy())
    np.testing.assert_array_equal(np.asarray(jp.cull.radii), tp.cull.radii.numpy())
    assert tp.cull.spans == jp.cull.spans == tp.soup.spans
    assert tp.cull.is_det == jp.cull.is_det == tp.soup_is_det
    # spheres contain their instance's triangles (theia_tpu's test_cull_tables_built)
    verts = np.concatenate([tp.w_v0, tp.w_v0 + tp.w_e1, tp.w_v0 + tp.w_e2])
    vinst = np.concatenate([inst] * 3)
    for k in range(n_inst):
        r = np.linalg.norm(verts[vinst == k] - tp.cull.centers[k].numpy(), axis=1).max()
        assert r <= float(tp.cull.radii[k])


def test_flagship_tables_equal():
    mesh = icosphere(3)
    jp = build_flagship(theia_tpu, mesh, 64, 2, accel="auto").scene.pack
    tt = build_flagship(theia_tpu_torch, mesh, 64, 2, accel="auto", device="cpu")
    tp = tt.scene.pack
    assert tt.scene.accel == "brute"
    for f in ("w_v0", "w_e1", "w_e2", "tri_data", "inst_data"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)), getattr(tp, f).numpy(), err_msg=f)
    assert tp.w_v0.shape == (3840, 3) and tp.shadow_split.det_v0.shape == (1280, 3)
    assert tp.shadow_split.nd_v0.shape == (2560, 3)
    assert tp.cull.spans == jp.cull.spans == ((0, 1280), (1280, 2560), (2560, 3840))
    assert tp.cull.is_det == jp.cull.is_det == (False, False, True)
    np.testing.assert_array_equal(np.asarray(jp.cull.centers), tp.cull.centers.numpy())
    np.testing.assert_array_equal(np.asarray(jp.cull.radii), tp.cull.radii.numpy())
    np.testing.assert_array_equal(np.asarray(jp.shadow_split.det_idx), tp.shadow_split.det_idx.numpy())
    # interop carries the same tables across
    carried = params_from_numpy({"scene": numpy_tree(jp)}, "cpu")["scene"]
    for f in ("w_v0", "tri_data", "inst_data"):
        assert torch.equal(getattr(carried, f), getattr(tp, f))
    assert carried.cull.spans == tp.cull.spans and carried.soup_is_det == tp.soup_is_det
    assert torch.equal(carried.soup.aos, tp.soup.aos) and torch.equal(carried.shadow_split.nd_v0, tp.shadow_split.nd_v0)


# -- the culled queries ----------------------------------------------------


def _same_fraction(got, want):
    return (np.asarray(got) == np.asarray(want)).mean()


@pytest.mark.parametrize("kind", ["three", "array"])
def test_culled_queries(packs, kind):
    jp, tp = packs[kind, True]
    o, d, t = _rays(N_RAYS, 30)
    active = np.random.default_rng(31).uniform(size=N_RAYS) < 0.7
    n_inst = len(tp.soup.spans)
    for groups, mask in ((None, None), ([n_inst - 1], active), ([0, 1], active), (list(range(2, n_inst)), None)):
        kw = dict(groups=groups, active=None if mask is None else jnp.asarray(mask))
        jt, ji = jax.jit(lambda o, d, t: jaccel.nearest_culled(jp, o, d, t, CHUNK, **kw))(o, d, t)
        jocc = jax.jit(lambda o, d, t: jaccel.anyhit_culled(jp, o, d, t, CHUNK, **kw))(o, d, t)
        tkw = dict(groups=groups, active=None if mask is None else torch.as_tensor(mask))
        tt, ti = taccel.nearest_culled(tp, *_tt(o, d, t), **tkw)
        tocc = taccel.anyhit_culled(tp, *_tt(o, d, t), **tkw)
        assert _same_fraction(ti, ji) >= 0.999
        both = (ti.numpy() >= 0) & (np.asarray(ji) >= 0)
        assert both.any() and _t_close(tt.numpy()[both], np.asarray(jt)[both])
        assert _same_fraction(tocc, jocc) >= 0.999
        if mask is not None:
            assert (ti.numpy()[~mask] == -1).all() and not tocc.numpy()[~mask].any()
        # against the port's own scan of the whole soup, bit for bit
        rows = np.concatenate([np.arange(*tp.soup.spans[k]) for k in (range(n_inst) if groups is None else groups)])
        in_groups = torch.zeros(tp.soup.n_tri, dtype=torch.bool)
        in_groups[torch.as_tensor(rows)] = True
        if groups is None:
            full_t, full_i = tsoup.nearest_in_soup(tp.w_v0, tp.w_e1, tp.w_e2, *_tt(o, d, t))
            assert torch.equal(tt, full_t) and torch.equal(ti, full_i)
        else:
            sub = torch.as_tensor(rows)
            sub_t, sub_i = tsoup.nearest_in_soup(tp.w_v0[sub], tp.w_e1[sub], tp.w_e2[sub], *_tt(o, d, t))
            keep = torch.ones(N_RAYS, dtype=torch.bool) if mask is None else torch.as_tensor(mask)
            want_i = torch.where(keep & (sub_i >= 0), sub[sub_i.clamp_min(0).long()].to(torch.int32), -1)
            assert torch.equal(ti, want_i) and torch.equal(tt, torch.where(want_i >= 0, sub_t, torch.inf))
            assert torch.equal(tocc, want_i >= 0)
    with pytest.raises(ValueError, match="brute"):
        mt_pack = _scene(theia_tpu_torch, "three", accel="mt").pack
        taccel.nearest_culled(mt_pack, *_tt(o, d, t))


_INT_FIELDS = ("instance", "custom_id", "flags", "inward", "medium_tr", "error")
_FLOAT_FIELDS = ("t", "world_pos", "ray_nrm", "obj_pos", "obj_nrm", "obj_dir")


def _hits_match(th, jh, mask=None):
    """Tolerance (d) of the module docstring, on the lanes of ``mask``."""
    mask = np.ones(th.valid.shape[0], bool) if mask is None else mask
    tv, jv = th.valid.numpy(), np.asarray(jh.valid)
    assert ((tv != jv) & mask).mean() <= 1e-3
    both = tv & jv & mask
    assert both.sum() > 50
    bad = np.zeros_like(both)
    for f in _INT_FIELDS:
        bad |= both & (getattr(th, f).numpy().astype(np.int64) != np.asarray(getattr(jh, f)).astype(np.int64))
    for f in _FLOAT_FIELDS:
        diff = np.abs(getattr(th, f).numpy().astype(np.float64) - np.asarray(getattr(jh, f)))
        scale = np.maximum(1.0, np.abs(np.asarray(getattr(jh, f))))
        close = diff <= 1e-5 * scale
        bad |= both & ~(close if close.ndim == 1 else close.all(axis=1))
    assert bad.mean() <= 1e-3, bad.mean()
    np.testing.assert_array_equal(th.world_to_obj.numpy()[both], np.asarray(jh.world_to_obj)[both])


@pytest.mark.parametrize("kind,cull", [("three", True), ("array", True), ("three", False), ("array", False)])
def test_intersect_target_matches_jax(packs, kind, cull):
    """The three routes of ``theia_tpu.accel.intersect_target``: the
    masked group scan (three spheres), ``nearest_culled`` over the detector
    groups (the array) and the plain subsoup (``cull=False``, where
    ``theia_tpu`` ignores ``active``: compared on the active lanes)."""
    jp, tp = packs[kind, cull]
    o, d, t = _aimed_rays(N_RAYS, 40)
    o[::2] = o[::2] * 0.3  # from between the spheres too
    active = np.random.default_rng(41).uniform(size=N_RAYS) < 0.7
    med = np.zeros(N_RAYS, np.int32)
    for mask in (None, active):
        jh = jax.jit(
            lambda o, d, t: jaccel.intersect_target(
                jp, jnp.asarray(med), o, d, t, active=None if mask is None else jnp.asarray(mask)
            )
        )(o, d, t)
        th = taccel.intersect_target(
            tp, *_tt(med, o, d, t), active=None if mask is None else torch.as_tensor(mask)
        )
        _hits_match(th, jh, mask)
        if mask is not None:
            assert not th.valid.numpy()[~mask].any()
        # only detector instances answer, and occluded lanes exist
        assert (th.instance.numpy()[th.valid.numpy()] >= 2).all()
    full = taccel.intersect_scene(tp, *_tt(med, o, d, t))
    blocked = full.valid & (full.instance < 2)
    assert blocked.any() and not th.valid[blocked & (full.t < th.t)].any()


def test_intersect_target_rows_from_query_or_gathered(packs):
    """The detector query returns the winners' rows; with ``tri_data``
    being differentiated, and with the measuring switch off, a torch
    gather fetches them. Every lane of every field is the same, the
    occluded and the masked ones too."""
    tp = packs["three", True][1]
    o, d, t = _aimed_rays(N_RAYS, 45)
    o[::2] = o[::2] * 0.3
    args = _tt(np.zeros(N_RAYS, np.int32), o, d, t)
    active = torch.as_tensor(np.random.default_rng(46).uniform(size=N_RAYS) < 0.7)
    from_query = taccel.intersect_target(tp, *args, active=active)
    leaf = dataclasses.replace(tp, tri_data=tp.tri_data.clone().requires_grad_(True))
    gathered = taccel.intersect_target(leaf, *args, active=active)
    assert gathered.world_pos.requires_grad and from_query.valid.sum() > 50
    taccel.ROWS_FROM_QUERY = False
    try:
        switched = taccel.intersect_target(tp, *args, active=active)
    finally:
        taccel.ROWS_FROM_QUERY = True
    for f in dataclasses.fields(from_query):
        for other in (gathered, switched):
            assert torch.equal(getattr(from_query, f.name), getattr(other, f.name).detach()), f.name


def test_intersect_target_falls_back(packs):
    """On an accelerated pack and on a pack without a detector the query
    is :func:`intersect_scene`, with ``active`` ignored, as in theia_tpu."""
    o, d, t = _aimed_rays(512, 50)
    med = np.zeros(512, np.int32)
    active = torch.zeros(512, dtype=torch.bool)
    mt_pack = _scene(theia_tpu_torch, "three", accel="mt").pack
    assert mt_pack.shadow_split is None and mt_pack.soup is None
    a = taccel.intersect_target(mt_pack, *_tt(med, o, d, t), active=active)
    b = taccel.intersect_scene(mt_pack, *_tt(med, o, d, t))
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert a.valid.any()


def test_is_visible_matches_jax(packs):
    o, d, t = _rays(N_RAYS, 60)
    target = o + d * (t * 0.5)[:, None]
    for key in (("three", True), ("three", False)):
        jp, tp = packs[key]
        want = np.asarray(jax.jit(lambda o, tg: jaccel.is_visible(jp, o, tg))(o, target))
        got = taccel.is_visible(tp, *_tt(o, target)).numpy()
        assert 0.02 < (~want).mean() < 0.98
        assert (got != want).mean() <= 1e-3
    mt_pack = _scene(theia_tpu_torch, "three", accel="mt").pack
    assert (taccel.is_visible(mt_pack, *_tt(o, target)).numpy() != got).mean() <= 1e-3


def test_translate_instance(packs):
    jp, tp = packs["three", True]
    delta = np.asarray([0.5, -0.25, 1.0], np.float32)
    jm, tm = jp.translate_instance(1, jnp.asarray(delta)), tp.translate_instance(1, delta)
    for f in ("w_v0", "w_e1", "w_e2", "tri_data"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)), getattr(tm, f).numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(jm.inst_data), tm.inst_data.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jm.cull.centers), tm.cull.centers.numpy())
    np.testing.assert_array_equal(np.asarray(jm.cull.radii), tp.cull.radii.numpy())
    np.testing.assert_array_equal(np.asarray(jm.shadow_split.nd_v0), tm.shadow_split.nd_v0.numpy())
    np.testing.assert_array_equal(np.asarray(jm.shadow_split.det_v0), tm.shadow_split.det_v0.numpy())
    # the pack it came from is untouched
    np.testing.assert_array_equal(np.asarray(jp.cull.centers), tp.cull.centers.numpy())
    assert not torch.equal(tm.w_v0, tp.w_v0)
    # the kernels' table follows: equal to that of a soup built afresh
    fresh = tsoup.SoupTable(tm.w_v0, tm.w_e1, tm.w_e2, tm.soup.spans)
    assert torch.equal(tm.soup.aos, fresh.aos) and torch.equal(tm.soup.chunk_box, fresh.chunk_box)
    assert not torch.equal(tm.soup.chunk_box, tp.soup.chunk_box)
    o, d, t = _aimed_rays(2048, 70)
    o[:, 2] += 0.5
    med = np.zeros(2048, np.int32)
    jh = jax.jit(lambda o, d, t: jaccel.intersect_scene(jm, jnp.asarray(med), o, d, t))(o, d, t)
    _hits_match(taccel.intersect_scene(tm, *_tt(med, o, d, t)), jh)
    moved = taccel.intersect_scene(tm, *_tt(med, o, d, t))
    assert (moved.instance[moved.valid] == 1).any()
    with pytest.raises(ValueError, match="brute"):
        _scene(theia_tpu_torch, "three", accel="mt").pack.translate_instance(1, delta)


# -- the slice as a whole --------------------------------------------------

BATCH = 4096
MAX_PATH = 10
GRAD_BATCH = 2048
GRAD_PATH = 3


def _hist_stats(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return abs(got.sum() / want.sum() - 1.0), np.abs(got - want).sum() / want.sum()


@pytest.fixture(scope="module")
def flagship_runs():
    """The default tracer of both packages (no ``accel`` named: "auto"
    resolves to brute force) on one batch."""
    mesh = icosphere(3)
    jt = build_flagship(theia_tpu, mesh, BATCH, MAX_PATH, accel="auto")
    assert jt.scene.accel == "brute"
    jt._debug_rng = True
    p = jt.params()
    j_state, _, j_dims = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    out = dict(j_hist=np.asarray(jt.response.result(p["response"], j_state)), j_dims=np.asarray(j_dims).astype(np.int64))
    tt = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="auto", device="cpu")
    tt._debug_rng = True
    tp = tt.params()
    with torch.no_grad():
        t_state, _, t_dims = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    out.update(t_hist=tt.response.result(tp["response"], t_state).numpy(), t_dims=t_dims.numpy().astype(np.int64))
    tt._debug_rng = False
    out["t_hist_interop"] = tt.run(params=params_from_numpy(numpy_tree(p), "cpu"))[0].numpy()
    return out


def test_brute_flagship_rng_dims_match(flagship_runs):
    same = flagship_runs["t_dims"] == flagship_runs["j_dims"]
    assert flagship_runs["j_dims"].max() > 40
    assert same.mean() >= 0.995, same.mean()


def test_brute_flagship_histogram_matches(flagship_runs):
    hist = flagship_runs["t_hist"]
    assert np.isfinite(hist).all() and hist.sum() > 0
    d_sum, l1 = _hist_stats(hist, flagship_runs["j_hist"])
    assert d_sum <= 1e-5, d_sum
    assert l1 <= 1e-2, l1


def test_brute_flagship_params_from_numpy_bit_equal(flagship_runs):
    np.testing.assert_array_equal(flagship_runs["t_hist_interop"], flagship_runs["t_hist"])


def _patched(p, media, tables):
    pp = dict(p)
    pp["scene"] = dataclasses.replace(p["scene"], media=dataclasses.replace(media, tables=tables))
    return pp


@pytest.fixture(scope="module")
def polarized_grads():
    """One polarized brute-force batch and its medium gradient, in both
    packages: d sum(state) / d (water absorption_coef row)."""
    mesh = icosphere(3)
    jt = build_flagship(theia_tpu, mesh, GRAD_BATCH, GRAD_PATH, accel="brute", polarized=True)
    fn, (p, counter, streams) = jt.trace_fn()
    media = p["scene"].media
    h = media.handle("water")

    def j_loss(row):
        tables = dict(media.tables)
        tables["absorption_coef"] = tables["absorption_coef"].at[h].set(row)
        state, _ = fn(_patched(p, media, tables), counter, streams)
        return jnp.sum(state), state

    (_, j_state), j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(media.tables["absorption_coef"][h])

    tt = build_flagship(theia_tpu_torch, mesh, GRAD_BATCH, GRAD_PATH, accel="brute", device="cpu", polarized=True)
    tfn, (tp, tcounter, tstreams) = tt.trace_fn()
    tmedia = tp["scene"].media
    leaf = tmedia.tables["absorption_coef"][h].clone().requires_grad_(True)
    table = tmedia.tables["absorption_coef"].clone()
    table[h] = leaf
    t_state, _ = tfn(_patched(tp, tmedia, {**tmedia.tables, "absorption_coef": table}), tcounter, tstreams)
    t_state.sum().backward()
    return dict(j_state=np.asarray(j_state), j_grad=np.asarray(j_grad),
                t_state=t_state.detach().numpy(), t_grad=leaf.grad.numpy())


def test_polarized_brute_batch_matches_jax(polarized_grads):
    d_sum, l1 = _hist_stats(polarized_grads["t_state"], polarized_grads["j_state"])
    assert polarized_grads["j_state"].sum() > 0
    assert d_sum <= 1e-5, d_sum
    assert l1 <= 1e-2, l1


def test_brute_gradient_matches_jax(polarized_grads):
    g, jg = polarized_grads["t_grad"], polarized_grads["j_grad"]
    np.testing.assert_array_equal(g != 0, jg != 0)
    assert (g != 0).sum() >= 10 and np.isfinite(g).all() and (g <= 0).all()
    np.testing.assert_allclose(g, jg, rtol=1e-3)
    np.testing.assert_allclose(g.sum(), jg.sum(), rtol=1e-5)
