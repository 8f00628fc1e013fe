"""The two-level instanced backend of the port (``accel="instanced"``, what
``accel="auto"`` picks for a detector array) against the live JAX
reference on the CPU, run as ``theia_tpu`` runs it by default (its
compaction ladder engages from 100 instances, so on these arrays its plain
walk runs), on in-code icosphere arrays (``torch_flagship.array_scene``:
27 spheres of 320 triangles, with a second prototype where ``mixed``;
``build_array``: example 08's 26 BK7-shelled modules).

Tolerances and why:
(a) pack: every table equal to ``theia_tpu``'s bit for bit (the same host
    code on the same float32 and float64 values).
(b) queries against ``theia_tpu``: hit or miss the same on >= 99.9 % of
    lanes, the same winner on >= 99.5 % of the lanes both hit, t within
    4 ulps on 90 % of them and rtol 3e-4 on all (tests/test_torch_brute.py's
    limits; at the extreme scales atol 1e-5 x scale, as
    tests/test_instanced.py:208): the candidates come in the same order (the
    cursor's float32 box math is the same), but the port's exact test takes
    a correctly rounded reciprocal and a Newton step where JAX divides, and
    the ray transform sums in a fixed order where XLA's einsum chooses its
    own, so t differs by ulps and a lane whose ray meets two triangles
    within ulps may pick the other.
(c) against the port's brute-force scan on the same scene: the same winner
    on >= 99.5 % of the lanes both hit and hit or miss the same on >= 99.9
    %, t rtol 1e-4 (atol 1e-5 x scale): object space against world space
    moves t by ulps of the transform.
(d) the any-hit equals ``nearest < t_max`` bit for bit, and
    ``theia_tpu``'s any-hit on >= 99.9 % of lanes (b). The sphere pretest is
    conservative: without it every answer is the same bit for bit.
(e) a traced batch on the array: RNG dims equal on >= 99.5 % of lanes,
    histogram sum rtol 1e-3 and per-bin L1 <= 1 % (the scene tracer's
    limits); example 08's ``HitRecorder``: the same count of valid hits,
    sorted times within 1e-5 relative (``PERF.md`` §2).
(f) the source-position gradient of tests/test_grad_scene.py:245 on
    ``"instanced"``: value and gradient rtol 1e-3 against ``jax.grad``
    (tests/test_torch_grad_geometry.py's limits and reasons).
(g) scenes whose hits tie exactly (``torch_flagship.tie_scene``: every
    prototype triangle twice, or two instances in one place): (b) against
    ``theia_tpu`` and (c) against the brute scan, whose rule (the lowest
    row) the walk's keeps: the first candidate in (t_entry, k) order, the
    lowest prototype row in it; the any-hit as (d).
(h) the kernel's rejection test in front of the exact test, on the
    prototype's rows with the rays in each instance's object space: no
    pair that the exact test accepts is rejected (the property
    tests/test_torch_intersect_filter.py holds on world-space soups, on
    which bit-equality with the plain walk rests), products rounded once
    and twice.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu.ops import instanced as jinst
from theia_tpu_torch import accel as taccel
from theia_tpu_torch.ops import instanced as tinst
from theia_tpu_torch.ops import intersect_mt as tmt
from torch_flagship import (
    TIE_KINDS, adversarial_rays, array_rays, array_scene, assert_winners_match, build_array, build_grad_scene,
    icosphere, tie_scene, uniform_rays,
)

torch.set_num_threads(1)

N_RAYS = 4096


@pytest.fixture(scope="module")
def scenes():
    return {
        mixed: (array_scene(theia_tpu, "instanced", mixed=mixed),
                array_scene(theia_tpu_torch, "instanced", mixed=mixed, device="cpu"))
        for mixed in (False, True)
    }


def _jax_query(pack, o, d, t_max, any_hit=False):
    fn = jinst.occluded_instanced if any_hit else jinst.nearest_triangle_instanced
    return fn(pack, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max, jnp.float32), 256)


@pytest.mark.parametrize("mixed", [False, True])
def test_pack_equals_jax(scenes, mixed):
    jscene, tscene = scenes[mixed]
    jp, tp = jscene.pack.instanced, tscene.pack.instanced
    assert tp.n_boxes == jp.n_boxes == 27 + mixed and len(tp.groups) == len(jp.groups) == 1 + mixed
    for jg, tg in zip(jp.groups, tp.groups):
        for name in ("v0", "e1", "e2", "w2o", "base"):
            want, got = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        for name in ("box", "sph"):
            want, got = getattr(jg, name), getattr(tg, name)
            assert (want is None) == (got is None), name
            for w, g in zip(want or (), got or ()):
                assert np.array_equal(g.numpy(), np.asarray(w)), name
        # the kernel's copies
        assert torch.equal(tg.tri, torch.cat([tg.v0, tg.e1, tg.e2], dim=1))
        assert tg.boxes.shape == (6 if tg.sph is None else 10, tg.box[0].numel())
    assert jp.groups[0].sph is not None  # sphere modules pack the sphere pretest
    for name in ("tri_data", "inst_data", "w_v0"):
        assert np.array_equal(getattr(tscene.pack, name).numpy(), np.asarray(getattr(jscene.pack, name))), name
    assert tscene.pack.soup is None and tscene.pack.bvh is None and tscene.pack.cull is None


@pytest.mark.parametrize("mixed", [False, True])
def test_nearest_matches_jax(scenes, mixed):
    jscene, tscene = scenes[mixed]
    o, d = uniform_rays(N_RAYS, 10 + mixed)
    jt, jidx = _jax_query(jscene.pack.instanced, o, d, np.inf)
    t, idx = tinst.nearest_triangle_instanced(tscene.pack.instanced, torch.as_tensor(o), torch.as_tensor(d), torch.inf)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    assert bool(torch.isinf(t[idx < 0]).all())
    assert_winners_match(t, idx, jt, jidx)


def test_respects_t_max(scenes):
    tscene = scenes[False][1]
    o, d = (torch.as_tensor(a) for a in uniform_rays(N_RAYS, 13))
    pack = tscene.pack.instanced
    t_far, i_far = tinst.nearest_triangle_instanced(pack, o, d, torch.inf)
    cap = 1.5
    t_cap, i_cap = tinst.nearest_triangle_instanced(pack, o, d, cap)
    beyond = (i_far >= 0) & (t_far >= cap)
    within = (i_far >= 0) & (t_far < cap)
    assert bool(beyond.any()) and bool(within.any())
    assert bool((i_cap[beyond] == -1).all())
    assert torch.equal(i_cap[within], i_far[within]) and torch.equal(t_cap[within], t_far[within])


def test_anyhit_is_nearest_below_t_max(scenes):
    """Tolerance (d), on per-lane bounds, a quarter of them infinite, and a
    few lanes with NaN rays, which neither query hits."""
    jscene, tscene = scenes[True]
    o, d = uniform_rays(N_RAYS, 14)
    rng = np.random.default_rng(15)
    t_max = np.where(rng.uniform(size=N_RAYS) < 0.25, np.inf, rng.uniform(0.1, 6.0, N_RAYS)).astype(np.float32)
    o[:8, 1] = np.nan
    d[8:16, 2] = np.nan
    t_max[16:24] = np.nan
    o_t, d_t, tm = (torch.as_tensor(a) for a in (o, d, t_max))
    pack = tscene.pack.instanced
    occ = tinst.occluded_instanced(pack, o_t, d_t, tm)
    _, idx = tinst.nearest_triangle_instanced(pack, o_t, d_t, tm)
    assert occ.dtype == torch.bool and torch.equal(occ, idx >= 0)
    assert not bool(occ[:24].any()) and 0.0 < float(occ.float().mean()) < 1.0
    j_occ = np.asarray(_jax_query(jscene.pack.instanced, o, d, t_max, any_hit=True))
    assert (occ.numpy() == j_occ).mean() >= 0.999


def test_sphere_pretest_changes_no_winner(scenes):
    """Without the bounding spheres every answer is the same, bit for bit."""
    tscene = scenes[True][1]
    pack = tscene.pack.instanced
    bare = dataclasses.replace(pack, groups=tuple(dataclasses.replace(g, sph=None) for g in pack.groups))
    assert any(g.sph is not None for g in pack.groups) and all(g.boxes.shape[0] == 6 for g in bare.groups)
    o, d = (torch.as_tensor(a) for a in uniform_rays(N_RAYS, 16))
    t, idx = tinst.nearest_triangle_instanced(pack, o, d, torch.inf)
    t_bare, idx_bare = tinst.nearest_triangle_instanced(bare, o, d, torch.inf)
    assert torch.equal(t_bare, t) and torch.equal(idx_bare, idx) and bool((idx >= 0).any())
    assert torch.equal(tinst.occluded_instanced(bare, o, d, 2.0), tinst.occluded_instanced(pack, o, d, 2.0))
    # and the pretest does skip candidates
    with_sph, without = {}, {}
    tinst.nearest_triangle_instanced_plain(pack, o, d, torch.full((N_RAYS,), torch.inf), stats=with_sph)
    tinst.nearest_triangle_instanced_plain(bare, o, d, torch.full((N_RAYS,), torch.inf), stats=without)
    assert with_sph["transforms"] < without["transforms"]


@pytest.mark.parametrize("mixed", [False, True])
def test_matches_the_brute_scan(scenes, mixed):
    """Tolerance (c), and ``is_visible`` through the any-hit walk."""
    tscene = scenes[mixed][1]
    brute = array_scene(theia_tpu_torch, "brute", mixed=mixed, device="cpu")
    o, d = (torch.as_tensor(a) for a in uniform_rays(N_RAYS, 17 + mixed))
    t, idx, _ = taccel._nearest(tscene.pack, o, d, torch.inf)
    tb, ib, _ = taccel._nearest(brute.pack, o, d, torch.inf)
    _assert_close_to_brute(t, idx, tb, ib, 1.0)
    target = o + 3.0 * d
    seen, seen_b = taccel.is_visible(tscene.pack, o, target), taccel.is_visible(brute.pack, o, target)
    assert float((seen == seen_b).float().mean()) >= 0.999 and 0.0 < float(seen.float().mean()) < 1.0


def _assert_close_to_brute(t, idx, tb, ib, scale):
    hit, hit_b = idx >= 0, ib >= 0
    assert bool(hit_b.any()) and float((hit == hit_b).float().mean()) >= 0.999
    both = hit & hit_b
    assert float((idx[both] == ib[both]).float().mean()) >= 0.995
    np.testing.assert_allclose(t[both].numpy(), tb[both].numpy(), rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", TIE_KINDS)
def test_tie_scenes_match_jax_and_brute(kind):
    """Tolerance (g): exact ties inside a candidate (duplicated rows) and
    across candidates (coincident instances)."""
    tscene = tie_scene(theia_tpu_torch, "instanced", kind, device="cpu")
    brute = tie_scene(theia_tpu_torch, "brute", kind, device="cpu")
    jscene = tie_scene(theia_tpu, "instanced", kind)
    o, d, t_max = array_rays(N_RAYS, 21, n_side=2)
    o_t, d_t, tm = (torch.as_tensor(a) for a in (o, d, t_max))
    t, idx = tinst.nearest_triangle_instanced(tscene.pack.instanced, o_t, d_t, torch.inf)
    jt, jidx = _jax_query(jscene.pack.instanced, o, d, np.inf)
    assert_winners_match(t, idx, jt, jidx)
    tb, ib, _ = taccel._nearest(brute.pack, o_t, d_t, torch.inf)
    _assert_close_to_brute(t, idx, tb, ib, 1.0)
    occ = tinst.occluded_instanced(tscene.pack.instanced, o_t, d_t, tm)
    _, idx_tm = tinst.nearest_triangle_instanced(tscene.pack.instanced, o_t, d_t, tm)
    assert torch.equal(occ, idx_tm >= 0) and 0.0 < float(occ.float().mean()) < 1.0


@pytest.mark.parametrize("scene", ["array", "duplicated rows"])
def test_rejection_never_drops_an_exact_hit_in_object_space(scene):
    """Tolerance (h), on example 08's array (26 modules of
    ``icosphere(2)``) and the tie scene's duplicated rows: random and
    adversarial rays moved into every instance's object space, against
    the rows the kernel reads (``GroupPack.rows``: the Moeller-Trumbore
    table's, ``intersect_mt.mt_aos``)."""
    if scene == "array":
        pack = build_array(theia_tpu_torch, icosphere(2), 64, 2, device="cpu").scene.pack
    else:
        pack = tie_scene(theia_tpu_torch, "instanced", scene, device="cpu").pack
    g = pack.instanced.groups[0]
    n_tri = g.v0.shape[0]
    aos = tmt.mt_aos(g.tri.T)[:n_tri]
    assert torch.equal(g.rows, aos[:, 4:20].reshape(n_tri, 4, 4).transpose(0, 1))
    o, d, _ = array_rays(1024, 23, n_side=3 if scene == "array" else 2)
    o_adv, d_adv = adversarial_rays(*(a.numpy() for a in (pack.w_v0, pack.w_e1, pack.w_e2)), seed=24, per_kind=32)
    o, d = (torch.as_tensor(np.concatenate(a)) for a in ((o, o_adv), (d, d_adv)))
    accepted, kept = 0, 0
    for k in range(g.w2o.shape[0]):
        o_obj, d_obj = tinst._transform(g.w2o[k].expand(o.shape[0], 12), o, d)
        _, hit = tmt._mt_exact_plain(g.tri.T, o_obj, d_obj)
        for fused in (True, False):
            rejected = tmt._mt_reject_plain(aos, o_obj, d_obj, fused)
            assert not bool((hit & rejected).any()), (k, fused)
            kept += int((~rejected).sum())
        accepted += int(hit.sum())
    # the test has hits to keep, and rejects nearly every pair
    assert accepted > 0 and kept < 0.05 * 2 * g.w2o.shape[0] * o.shape[0] * n_tri


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_extreme_scales(scale):
    """The scale-normalized prototype keeps the exact test's |det| cutoff
    what it is in world space (tests/test_instanced.py:208): instances of
    a thousandth and a thousand times the size, against the brute scan and
    ``theia_tpu``."""
    tscene = array_scene(theia_tpu_torch, "instanced", n_side=2, scale=scale, device="cpu")
    brute = array_scene(theia_tpu_torch, "brute", n_side=2, scale=scale, device="cpu")
    jscene = array_scene(theia_tpu, "instanced", n_side=2, scale=scale)
    o, d = uniform_rays(N_RAYS, 19, lo=-2.0 * scale, hi=4.0 * scale)
    o_t, d_t = torch.as_tensor(o), torch.as_tensor(d)
    t, idx = tinst.nearest_triangle_instanced(tscene.pack.instanced, o_t, d_t, torch.inf)
    tb, ib, _ = taccel._nearest(brute.pack, o_t, d_t, torch.inf)
    _assert_close_to_brute(t, idx, tb, ib, scale)
    jt, jidx = (np.asarray(a) for a in _jax_query(jscene.pack.instanced, o, d, np.inf))
    hit, jhit = idx.numpy() >= 0, jidx >= 0
    assert jhit.any() and (hit == jhit).mean() >= 0.999
    both = hit & jhit
    assert (idx.numpy()[both] == jidx[both]).mean() >= 0.995
    np.testing.assert_allclose(t.numpy()[both], jt[both], rtol=3e-4, atol=1e-5 * scale)


def test_auto_selects_instanced():
    """``theia_tpu``'s rule: 26 modules of ``icosphere(2)`` are 8,320
    triangles, past ``AUTO_INSTANCED_THRESHOLD`` (8,192), in both packages;
    one module, or 25 (8,000 triangles), stay brute force."""
    mesh = icosphere(2)
    for pkg in (theia_tpu, theia_tpu_torch):
        dev = {"device": "cpu"} if pkg is theia_tpu_torch else {}
        assert build_array(pkg, mesh, 64, 2, **dev).scene.accel == "instanced"
        scene = build_array(pkg, mesh, 64, 2, **dev).scene
        assert sum(len(i.mesh.indices) for i in scene.instances) == 26 * 320
        few = pkg.scene.Scene(scene.instances[:25], scene.materials, medium="water", **dev)
        assert few.accel == "brute"
        one = pkg.scene.Scene(scene.instances[:1], scene.materials, medium="water", **dev)
        assert one.accel == "brute"
    assert theia_tpu_torch.scene.AUTO_INSTANCED_THRESHOLD == theia_tpu.scene.AUTO_INSTANCED_THRESHOLD


def test_translate_instance_raises():
    pack = array_scene(theia_tpu_torch, "instanced", n_side=2, device="cpu").pack
    with pytest.raises(ValueError, match="brute"):
        pack.translate_instance(0, torch.zeros(3))


def _jax_run(tracer):
    tracer._debug_rng = True
    p = tracer.params()
    state, _, dims = jax.jit(tracer._trace_batch)(p, tracer.rng.counter_words, tracer.streams())
    return tracer.response.result(p["response"], state), np.asarray(dims)


def _port_run(tracer):
    tracer._debug_rng = True
    p = tracer.params()
    with torch.no_grad():
        state, _, dims = tracer._trace_batch(p, tracer.rng.counter_words, tracer.streams())
    return tracer.response.result(p["response"], state), dims.numpy()


@pytest.mark.parametrize("response", ["histogram", "hit recorder"])
def test_traced_batch_matches_jax(response):
    """Tolerance (e): example 08's array (26 modules of ``icosphere(2)``,
    which ``accel="auto"`` sends to the instanced walk) at batch 4096,
    path length 8."""
    make = {
        "histogram": lambda pkg: pkg.response.HistogramHitResponse(nBins=60, t0=0.0, binSize=2.0),
        "hit recorder": lambda pkg: pkg.response.HitRecorder(),
    }[response]
    jt = build_array(theia_tpu, icosphere(2), 4096, 8, response=make(theia_tpu))
    tt = build_array(theia_tpu_torch, icosphere(2), 4096, 8, response=make(theia_tpu_torch), device="cpu")
    assert jt.scene.accel == tt.scene.accel == "instanced"
    j_res, j_dims = _jax_run(jt)
    t_res, t_dims = _port_run(tt)
    assert (t_dims == j_dims).mean() >= 0.995
    if response == "histogram":
        j_hist, t_hist = np.asarray(j_res, np.float64), t_res.numpy().astype(np.float64)
        assert j_hist.sum() > 0.0
        assert abs(t_hist.sum() / j_hist.sum() - 1.0) <= 1e-3
        assert np.abs(t_hist - j_hist).sum() / j_hist.sum() <= 1e-2
        return
    j_times = np.sort(np.asarray(j_res["time"])[np.asarray(j_res["valid"])])
    t_times = np.sort(t_res["time"][t_res["valid"]].numpy())
    assert len(j_times) == len(t_times) > 0
    np.testing.assert_allclose(t_times, j_times, rtol=1e-5, atol=0.0)
    # every module of the array is hit, each by its own detector id
    ids = t_res["objectId"][t_res["valid"]].numpy()
    assert set(ids.tolist()) <= set(range(26)) and len(set(ids.tolist())) >= 13


def test_source_gradient_matches_jax():
    """Tolerance (f): tests/test_grad_scene.py:245's relative squared
    mismatch of four modules' kernel-histogram light curves in the
    source's x, on ``accel="instanced"`` as that test names it."""
    batch = 4096
    obs_at = (0.3, -0.2, 0.0)

    def curves(p0, fn, counter, streams, pos):
        return fn({**p0, "lightSource": {**p0["lightSource"], "position": pos}}, counter, streams)[0]

    jt = build_grad_scene(theia_tpu, "source", batch, accel="instanced")
    assert jt.scene.pack.instanced is not None
    fn, (p0, counter, streams) = jt.trace_fn()
    obs = curves(p0, fn, counter, streams, jnp.asarray(obs_at, jnp.float32))

    def j_loss(x):
        c = curves(p0, fn, counter, streams, jnp.stack([x, jnp.float32(0.0), jnp.float32(0.0)]))
        return jnp.sum((c - obs) ** 2) / jnp.sum(obs**2)

    j_value, j_grad = jax.jit(jax.value_and_grad(j_loss))(jnp.float32(0.0))
    tt = build_grad_scene(theia_tpu_torch, "source", batch, "cpu", accel="instanced")
    assert tt.scene.pack.instanced is not None
    fn, (p0, counter, streams) = tt.trace_fn()
    with torch.no_grad():
        t_obs = curves(p0, fn, counter, streams, torch.tensor(obs_at))
    x = torch.tensor(0.0, requires_grad=True)
    c = curves(p0, fn, counter, streams, torch.stack([x, torch.tensor(0.0), torch.tensor(0.0)]))
    value = ((c - t_obs) ** 2).sum() / (t_obs**2).sum()
    value.backward()
    assert np.isfinite(float(x.grad)) and value.item() > 0.0
    np.testing.assert_allclose(value.item(), float(j_value), rtol=1e-3)
    np.testing.assert_allclose(float(x.grad), float(j_grad), rtol=1e-3)
