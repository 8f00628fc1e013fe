"""Public names of ``theia_tpu`` that the port must answer to as well:
``theia_tpu_torch.render``, ``accel.anyhit_in_soup`` / ``nearest_in_soup``,
the JAX keywords of the MT and Woop nearest-hit queries (``binned`` sorts
the rays and changes no bit; the others are accepted and ignored), and
the names of the Cherenkov slice: the planar
target guides, the Cherenkov, particle, host and tabulated light sources,
``cascades``, ``items``, ``ops.gamma`` and the value queue's estimators;
and every name of ``__all__`` of the last single-card modules (``lookup``,
``material``, ``mesh``, ``render``, ``testing``, ``ops.sampling``,
``pipeline``, ``task``, ``trace`` and ``native``); and, walking every module
of ``theia_tpu`` with pkgutil, each module's counterpart with every name
of its ``__all__`` but one explicit list of exclusions, each with its
reason.

Tolerances and why: the soup queries against ``theia_tpu``'s as in
tests/test_torch_brute.py (b): JAX divides by det, the port takes a
reciprocal and a Newton step, so t agrees to T_RTOL relative and the
winner on all but 0.1 % of the lanes (two hits that close), any-hit
flags likewise; the keywords change nothing, bit for bit."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu.accel as jaccel
import theia_tpu_torch
from torch_flagship import build_flagship, icosphere

torch.set_num_threads(1)

CHUNK = 256
N_RAYS = 2048
T_RTOL = 3e-4


def test_render_is_a_submodule():
    import theia_tpu
    import theia_tpu.render

    assert "render" in theia_tpu_torch.__all__ and "render" in theia_tpu.__all__
    render = theia_tpu_torch.render
    assert render.__name__ == "theia_tpu_torch.render"
    assert render.SceneTemplate.__name__ == "SceneTemplate"
    assert set(render.__all__) <= set(theia_tpu.render.__all__)


def test_accel_exports_the_soup_queries():
    import theia_tpu_torch.accel as taccel
    from theia_tpu_torch.ops import intersect_soup

    assert taccel.anyhit_in_soup is intersect_soup.anyhit_in_soup
    assert taccel.nearest_in_soup is intersect_soup.nearest_in_soup
    assert sorted(taccel.__all__) == sorted(jaccel.__all__)
    assert "anyhit_in_soup" in taccel.__all__


@pytest.fixture(scope="module")
def small_soup():
    pack = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, accel="brute", device="cpu").scene.pack
    return pack.w_v0.numpy(), pack.w_e1.numpy(), pack.w_e2.numpy()


def _aimed(n: int, seed: int):
    """Rays from around the flagship's spheres, half aimed at their centres,
    with finite bounds on half of them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 4.5, (n, 3)).astype(np.float32)
    centres = np.asarray([[3.0, 0.0, 0.0], [0.0, 3.0, 0.0], [0.0, 0.0, 0.0]])[rng.integers(0, 3, n)]
    aim = centres + rng.normal(scale=0.4, size=(n, 3)) - o
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim, rng.normal(size=(n, 3))).astype(np.float32)
    t = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.2, 3.0, n), np.inf).astype(np.float32)
    return o, d, t


@pytest.mark.parametrize("seed", [1, 2])
def test_accel_soup_queries_match_jax(small_soup, seed):
    import theia_tpu_torch.accel as taccel

    v0, e1, e2 = small_soup
    o, d, t = _aimed(N_RAYS, seed)
    jt, ji = (np.asarray(a) for a in jax.jit(lambda *a: jaccel.nearest_in_soup(*a, CHUNK))(v0, e1, e2, o, d, t))
    tt, ti = (a.numpy() for a in taccel.nearest_in_soup(*(torch.as_tensor(a) for a in (v0, e1, e2, o, d, t))))
    assert (ji >= 0).mean() > 0.1, "the rays hit the soup"
    assert (ti != ji).mean() <= 1e-3
    both = (ti >= 0) & (ji >= 0)
    np.testing.assert_allclose(tt[both], jt[both], rtol=T_RTOL, atol=0.0)
    jocc = np.asarray(jax.jit(lambda *a: jaccel.anyhit_in_soup(*a, CHUNK))(v0, e1, e2, o, d, jnp.asarray(t)))
    tocc = taccel.anyhit_in_soup(*(torch.as_tensor(a) for a in (v0, e1, e2, o, d, t))).numpy()
    assert 0.0 < jocc.mean() < 1.0
    assert (tocc != jocc).mean() <= 1e-3


def _rays_t(seed: int):
    o, d, t = _aimed(N_RAYS, seed)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(torch.as_tensor(a) for a in (o, d, t))


@pytest.mark.parametrize("keywords", [
    dict(interpret=None, binned=None, bn=256),
    dict(interpret=True, binned=True, bn=512),
    dict(binned=False),
])
def test_nearest_triangle_mt_takes_jax_keywords(keywords):
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt

    pack = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, accel="mt", device="cpu").scene.pack.mt
    o, d, t = _rays_t(3)
    want_t, want_i = nearest_triangle_mt(pack, o, d, t)
    got_t, got_i = nearest_triangle_mt(pack, o, d, t, **keywords)
    assert (want_i >= 0).any()
    assert torch.equal(got_i, want_i) and torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))


@pytest.mark.parametrize("keywords", [
    dict(precision="highest", binned=None),
    dict(interpret=None, precision="default", binned=True),
])
def test_nearest_triangle_woop_takes_jax_keywords(keywords):
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop

    pack = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, accel="woop", device="cpu").scene.pack.woop
    o, d, t = _rays_t(4)
    want_t, want_i = nearest_triangle_woop(pack, o, d, t)
    got_t, got_i = nearest_triangle_woop(pack, o, d, t, **keywords)
    assert (want_i >= 0).any()
    assert torch.equal(got_i, want_i) and torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))


def test_cherenkov_slice_names():
    """Every name of the slice importable from the port under theia_tpu's
    name (``light.LightSampler`` resolves to ``testing``'s, as in theia_tpu)."""
    import theia_tpu.cascades, theia_tpu.items, theia_tpu.light, theia_tpu.ops.gamma, theia_tpu.response
    import theia_tpu.target
    import theia_tpu_torch.cascades, theia_tpu_torch.items, theia_tpu_torch.ops.gamma

    for name in ("cascades", "items"):
        assert sorted(getattr(theia_tpu_torch, name).__all__) == sorted(getattr(theia_tpu, name).__all__), name
    assert set(theia_tpu.target.__all__) <= set(theia_tpu_torch.target.__all__)
    assert set(theia_tpu.response.__all__) <= set(theia_tpu_torch.response.__all__)
    assert set(theia_tpu.light.__all__) <= set(theia_tpu_torch.light.__all__)
    assert set(theia_tpu.ops.gamma.__all__) <= set(theia_tpu_torch.ops.gamma.__all__)
    for module in ("light", "response", "target", "cascades", "items"):
        m = importlib.import_module(f"theia_tpu_torch.{module}")
        missing = [n for n in m.__all__ if not hasattr(m, n)]
        assert not missing, (module, missing)
    slice_names = dict(
        target="FlatTargetGuide DiskTargetGuide _PlanarTargetGuide _guide_sample_from_point",
        light="frankTamm _frank_tamm_photons _frank_tamm_energy _rotate_to CherenkovLightSource ParticleTrack "
        "CherenkovTrackLightSource _sample_emission_angle _eval_emission_angle MuonTrackLightSource "
        "ParticleCascadeLightSource FunctionWavelengthSource HostWavelengthSource HostLightSource "
        "StreamingHostWavelengthSource StreamingHostLightSource LightSampleItem PolarizedLightSampleItem "
        "WavelengthSampleItem",
        response="CustomValueResponse EmptyResponse SampleValueResponse StoreValueHitResponse Estimator "
        "HistogramReducer createHitTimeQueue createValueQueue HistogramEstimator HostEstimator replay_hits "
        "sample_camera_hits HitReplay CameraHitResponseSampler ValueItem HitTimeItem HitTimeAndIdItem",
    )
    for module, names in slice_names.items():
        for pkg in ("theia_tpu", "theia_tpu_torch"):
            m = importlib.import_module(f"{pkg}.{module}")
            missing = [n for n in names.split() if not hasattr(m, n)]
            assert not missing, (pkg, module, missing)
    assert theia_tpu_torch.light.LightSampleItem is theia_tpu_torch.items.LightSampleItem
    assert theia_tpu_torch.response.ValueItem is theia_tpu_torch.items.ValueItem
    assert {"cascades", "items"} <= set(theia_tpu_torch.__all__)


SINGLE_CARD_MODULES = ("lookup", "material", "mesh", "render", "testing", "ops.sampling", "ops.math3d", "pipeline",
                       "task", "trace", "native", "light")


@pytest.mark.parametrize("module", SINGLE_CARD_MODULES)
def test_single_card_slice_names(module):
    """Every name of ``theia_tpu``'s ``__all__`` in the modules of the last
    single-card slice exists in the port's module (``trace`` has no
    ``__all__`` in theia_tpu: its ``Tracer`` alias is checked by name), and
    the port's ``__all__`` lists only names it has."""
    jmod = importlib.import_module(f"theia_tpu.{module}")
    tmod = importlib.import_module(f"theia_tpu_torch.{module}")
    names = set(getattr(jmod, "__all__", ())) | ({"Tracer"} if module == "trace" else set())
    if module == "ops.math3d":
        names |= {"INF"}
    if module == "ops.sampling":
        names |= {"INV_PI"}
    missing = sorted(n for n in names if not hasattr(tmod, n))
    assert not missing, (module, missing)
    assert not [n for n in getattr(tmod, "__all__", ()) if not hasattr(tmod, n)], module
    assert set(getattr(jmod, "__all__", ())) <= set(getattr(tmod, "__all__", names)), module


def test_single_card_submodules_and_aliases():
    assert {"pipeline", "task"} <= set(theia_tpu_torch.__all__)
    assert theia_tpu_torch.pipeline.__name__ == "theia_tpu_torch.pipeline"
    assert theia_tpu_torch.task.ConvergeHistogramTask is theia_tpu_torch.pipeline.ConvergeHistogramTask
    assert theia_tpu_torch.trace.Tracer is theia_tpu_torch.trace.TracerBase
    lk = theia_tpu_torch.lookup
    assert (lk.evalTable, lk.sampleTable1D, lk.sampleTable2D) == (lk.eval_table, lk.sample_table1d, lk.sample_table2d)
    assert isinstance(theia_tpu_torch.native.native_available(), bool)
    assert theia_tpu_torch.material.Medium.save and theia_tpu_torch.material.Medium.load


#: names of theia_tpu's ``__all__`` that the port leaves out, by module,
#: each with its reason (ROADMAP.md's "Not to port")
NOT_PORTED = {
    "ops._intersect_tiles": {
        "rcp": "the Pallas kernels' approximate reciprocal; the port's scans take __frcp_rn and a Newton step",
        "block_slab_hit": "a Pallas kernel body's per-(ray block, tile) slab test; the scans test chunk boxes",
        "select_winner": "a Pallas kernel body's min/iota winner reduction; the scans keep (t bits, index) keys",
        "pack_rays": "pads rays to a Pallas grid of ray blocks; the CUDA scans take any N",
        "check_vmem_budget": "the TPU's VMEM budget for a resident triangle table; the scans stream their tables",
    },
}
#: theia_tpu modules with no counterpart module of that name in the port
MODULE_MAP = {"ops.intersect_mt_pallas": "ops.intersect_mt"}
#: theia_tpu modules that are no Python module of names
NOT_MODULES = {"native.libbvh": "the compiled BVH builder, a shared library; the port builds its own copy of "
                                "native/bvh.cpp with g++ at first use"}


def jax_modules():
    import pkgutil

    import theia_tpu

    names = [m.name[len("theia_tpu."):] for m in pkgutil.walk_packages(theia_tpu.__path__, "theia_tpu.")]
    return [""] + sorted(n for n in names if n not in NOT_MODULES)


@pytest.mark.parametrize("module", jax_modules())
def test_port_has_every_module_and_name(module):
    """Every module of theia_tpu (walked with pkgutil: parallel.*,
    profiling and ops._intersect_tiles too) has its counterpart in the
    port, with every name of its ``__all__`` but the listed exclusions."""
    jmod = importlib.import_module("theia_tpu" + (f".{module}" if module else ""))
    tname = MODULE_MAP.get(module, module)
    tmod = importlib.import_module("theia_tpu_torch" + (f".{tname}" if tname else ""))
    skip = NOT_PORTED.get(module, {})
    missing = sorted(n for n in getattr(jmod, "__all__", ()) if n not in skip and not hasattr(tmod, n))
    assert not missing, (module, missing)
    assert not [n for n in skip if hasattr(tmod, n)], "an excluded name is ported: take it off the list"


def test_exclusions_name_real_names():
    import pkgutil

    import theia_tpu

    for module, names in NOT_PORTED.items():
        assert set(names) <= set(importlib.import_module(f"theia_tpu.{module}").__all__), module
    walked = {m.name[len("theia_tpu."):] for m in pkgutil.walk_packages(theia_tpu.__path__, "theia_tpu.")}
    assert set(NOT_MODULES) | set(MODULE_MAP) <= walked
    assert {"parallel", "parallel.dataparallel", "parallel.runner", "parallel.multihost", "profiling",
            "ops._intersect_tiles"} <= walked


def test_last_slice_names():
    import theia_tpu_torch.ops._intersect_tiles as tiles
    import theia_tpu_torch.parallel as par
    import theia_tpu_torch.profiling as prof

    assert len(par.__all__) == 9 and all(hasattr(par, n) for n in par.__all__)
    assert sorted(prof.__all__) == ["batch_timings", "profile_batch", "trace_profile"]
    assert {"octant_cell_key", "run_binned", "BIN_CELLS", "BIN_THRESHOLD"} <= set(tiles.__all__)
    assert (tiles.BIN_CELLS, tiles.BIN_THRESHOLD) == (4, 8192)
    assert {"parallel", "profiling"} <= set(theia_tpu_torch.__all__)
    assert theia_tpu_torch.parallel.dataparallel.BATCH_AXIS == "batch"
