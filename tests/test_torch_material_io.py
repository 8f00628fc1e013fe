"""theia_tpu_torch.material's archives and ocean-water phase functions
against theia_tpu.material.

Tolerances and why:
(a) Fournier-Forand's tables: the same numpy and scipy code on the host,
    stored as float32, so ``log_phase_function`` and ``phase_sampling``
    are equal within float32 rounding (checked at 1 ulp: rtol 2**-23);
    the Kokhanovsky matrix's four tables equal, bit for bit, those that
    the port got through ``interop`` from JAX's class before this class
    was ported.
(b) archives: written by either package and read by the other, every
    table is equal bit for bit, flags and medium names alike; every bad
    ``material.json`` that JAX's jsonschema check rejects raises
    ``ValueError`` in the port (no jsonschema there).
(c) the volume flagship with Fournier-Forand in Henyey-Greenstein's
    place, each package tracing its own medium, by test_torch_volume's
    agreement: RNG dims equal on >= 99.5 % of lanes, histogram sum
    within rtol 1e-5, every bin within 1e-5 of the largest."""

import json
from zipfile import ZipFile

import numpy as np
import pytest
import torch

import jax
import jsonschema

import theia_tpu
import theia_tpu.material as jm
import theia_tpu_torch
import theia_tpu_torch.material as tm
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import (
    FF_PARAMETERS, build_pol_backward, build_volume_flagship, ff_water_medium, numpy_tree, pol_water_medium,
)

torch.set_num_threads(1)

FF = FF_PARAMETERS


def ff_water(mod, **kw):
    return ff_water_medium(mod, **kw)


def pol_water(mod):
    return pol_water_medium(mod)


@pytest.mark.parametrize("num_theta", [64, 1024])
def test_fournier_forand_tables_match_jax(num_theta):
    j, t = ff_water(jm, num_theta=num_theta), ff_water(tm, num_theta=num_theta)
    for kind in ("log_phase_function", "phase_sampling"):
        a, b = np.asarray(getattr(j, kind)), getattr(t, kind)
        assert b.dtype == np.float32 and np.isfinite(b).all(), kind
        np.testing.assert_allclose(b, a, rtol=2.0**-23, atol=0.0, err_msg=kind)
    model = tm.FournierForandPhaseFunction(*FF)
    x = np.linspace(-1.0, 1.0, 513)
    np.testing.assert_array_equal(model.log_phase_function(x), jm.FournierForandPhaseFunction(*FF).log_phase_function(x))
    model.n, model.mu = 1.1, 3.8  # the spline follows the parameters
    np.testing.assert_array_equal(
        model.phase_sampling(np.linspace(0.0, 1.0, 65)),
        jm.FournierForandPhaseFunction(1.1, 3.8).phase_sampling(np.linspace(0.0, 1.0, 65)),
    )


def test_kokhanovsky_tables_match_interop():
    jax_medium = pol_water(jm)
    through_interop = params_from_numpy({"medium": numpy_tree(jax_medium)}, "cpu")["medium"]
    ported = pol_water(tm).to("cpu")
    for kind in ("phase_m12", "phase_m22", "phase_m33", "log_phase_function", "phase_sampling"):
        assert torch.equal(getattr(ported, kind), getattr(through_interop, kind)), kind
    assert ported.phase_m34 is None and through_interop.phase_m34 is None
    ct = np.linspace(-1.0, 1.0, 512)
    model = tm.KokhanovskyOceanWaterPhaseMatrix(p90=0.66, theta0=0.25, alpha=0.55, xi=0.04)
    assert np.all(np.abs(model.phase_m12(ct)) <= 1.0)
    assert np.all(np.abs(model.phase_m22(ct)) <= 1.0 + 1e-6)
    assert np.all(np.abs(model.phase_m33(ct)) <= 1.0 + 1e-6)


def _materials(mod):
    water = ff_water(mod, num_lambda=32, num_theta=16)
    glass = mod.BK7Model().createMedium(num_lambda=32, num_theta=4)
    return [
        mod.Material("det", water, None, flags=("DB", "T")),
        mod.Material("glass_water", glass, water, flags="TR"),
        mod.Material("air_glass", None, "bk7", flags="TR"),
    ], [pol_water(mod)]


def _tables_equal(a, b):
    assert float(a.lambda_min) == float(b.lambda_min) and float(a.lambda_max) == float(b.lambda_max)
    for kind in tm._TABLE_PROPS:
        x, y = getattr(a, kind), getattr(b, kind)
        assert (x is None) == (y is None), kind
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=kind)


@pytest.mark.parametrize("writer", ["jax", "port", "port from tensors"])
def test_archives_cross_load(tmp_path, writer):
    path = tmp_path / "materials.zip"
    mod = jm if writer == "jax" else tm
    materials, extra = _materials(mod)
    if writer == "port from tensors":  # the media's tables as tensors, as Medium.to gives them
        extra = [extra[0].to("cpu")]
    mod.saveMaterials(path, materials, media=extra)
    with ZipFile(path) as zf:
        names = sorted(zf.namelist())
    assert names == ["material.json", "media/bk7.npz", "media/ff_water.npz", "media/pol_water.npz"]
    reader = tm if writer == "jax" else jm
    for read in (reader, mod):
        mats, media = read.loadMaterials(path)
        assert sorted(media) == ["bk7", "ff_water", "pol_water"]
        for m in materials:
            got = mats[m.name]
            assert (got.flagsInward, got.flagsOutward) == (m.flagsInward, m.flagsOutward)
            assert read.serializeMedium(got.inside) == mod.serializeMedium(m.inside)
            assert read.serializeMedium(got.outside) == mod.serializeMedium(m.outside)
        _tables_equal(media["ff_water"], materials[0].inside)
        _tables_equal(media["pol_water"], pol_water(tm))
    port_media = tm.loadMaterials(path)[1]
    store = tm.MaterialStore.pack(list(tm.loadMaterials(path)[0].values()), device="cpu")
    assert store.media.names[1:] == ("ff_water", "bk7")
    assert all(isinstance(m.refractive_index, np.ndarray) for m in port_media.values())


def test_medium_save_load_roundtrip(tmp_path):
    medium = ff_water(tm, num_lambda=16, num_theta=8)
    path = tmp_path / "m.npz"
    medium.to("cpu").save(path)
    back = tm.Medium.load(path, name="again")
    assert back.name == "again"
    _tables_equal(back, medium)
    _tables_equal(jm.Medium.load(path), medium)
    with open(tmp_path / "t.txt", "w") as f, pytest.raises(ValueError):
        medium.save(f)
    np.savez(tmp_path / "bad.npz", refractive_index=np.ones(4))
    with pytest.raises(ValueError, match="lambda range"):
        tm.Medium.load(tmp_path / "bad.npz")


GOOD = {"name": "det", "inside": "ff_water", "outside": None, "flagsInward": 0, "flagsOutward": 0}
BAD_JSON = {
    "missing keys": [{"name": "det", "inside": "ff_water"}],
    "extra key": [dict(GOOD, colour="red")],
    "name a number": [dict(GOOD, name=3)],
    "inside a number": [dict(GOOD, inside=1)],
    "outside a list": [dict(GOOD, outside=["ff_water"])],
    "flags a string": [dict(GOOD, flagsInward="DB")],
    "flags a boolean": [dict(GOOD, flagsOutward=True)],
    "flags below zero": [dict(GOOD, flagsInward=-1)],
    "flags null": [dict(GOOD, flagsOutward=None)],
    "entry not an object": ["det"],
    "not an array": GOOD,
}


def _rewrite(src, dst, entries):
    with ZipFile(src) as zin, ZipFile(dst, "w") as zout:
        for info in zin.infolist():
            if info.filename == "material.json":
                zout.writestr(info.filename, json.dumps(entries))
            else:
                zout.writestr(info.filename, zin.read(info))


@pytest.fixture(scope="module")
def good_archive(tmp_path_factory):
    path = tmp_path_factory.mktemp("archive") / "good.zip"
    tm.saveMaterials(path, [tm.Material("det", ff_water(tm, num_lambda=8, num_theta=8), None, flags="DB")])
    return path


@pytest.mark.parametrize("case", sorted(BAD_JSON))
def test_bad_material_json_raises(good_archive, tmp_path, case):
    bad = tmp_path / "bad.zip"
    _rewrite(good_archive, bad, BAD_JSON[case])
    with pytest.raises(jsonschema.ValidationError):
        jm.loadMaterials(bad)
    with pytest.raises(ValueError):
        tm.loadMaterials(bad)


def test_material_json_errors_after_the_schema(good_archive, tmp_path):
    """tests/test_material.py's other cases: skipValidation lets the missing
    keys surface as a KeyError; a dangling medium and a name given twice
    raise ValueError; so does an archive without material.json."""
    bad = tmp_path / "bad.zip"
    _rewrite(good_archive, bad, BAD_JSON["missing keys"])
    for mod in (jm, tm):
        with pytest.raises(KeyError):
            mod.loadMaterials(bad, skipValidation=True)
    dangling = tmp_path / "dangling.zip"
    _rewrite(good_archive, dangling, [dict(GOOD, inside="missing_medium")])
    dup = tmp_path / "dup.zip"
    _rewrite(good_archive, dup, [GOOD, GOOD])
    for path, match in ((dangling, "unknown medium"), (dup, "duplicate")):
        for mod in (jm, tm):
            with pytest.raises(ValueError, match=match):
                mod.loadMaterials(path)
    empty = tmp_path / "empty.zip"
    with ZipFile(empty, "w") as zf:
        zf.writestr("media/readme.txt", "no json")
    with pytest.raises(ValueError, match="material.json"):
        tm.loadMaterials(empty)
    ok = tmp_path / "ok.zip"
    _rewrite(good_archive, ok, [dict(GOOD, flagsInward=2.0), dict(GOOD, name="b", inside=None, outside="ff_water")])
    assert sorted(tm.loadMaterials(ok)[0]) == sorted(jm.loadMaterials(ok)[0]) == ["b", "det"]


def test_ocean_ff_volume_matches_jax():
    """The volume flagship with Fournier-Forand in HG's place (phase 3n's
    ocean-ff-volume, small), each package on its own medium."""
    jt = build_volume_flagship(theia_tpu, 2048, medium=ff_water(jm))
    tt = build_volume_flagship(theia_tpu_torch, 2048, "cpu", medium=ff_water(tm))
    jt._debug_rng = tt._debug_rng = True
    p = jt.params()
    js, _, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = tt.params()
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    jh = np.asarray(jt.response.result(p["response"], js), np.float64)
    th = tt.response.result(tp["response"], ts).double().numpy()
    same = (np.asarray(jd).astype(np.int64) == td.numpy()).mean()
    assert same >= 0.995, same
    assert jh.sum() > 0 and abs(th.sum() / jh.sum() - 1.0) <= 1e-5
    assert np.abs(th - jh).max() <= 1e-5 * jh.max()


def test_kokhanovsky_backward_matches_jax():
    """tests/test_polarized_backward.py's polarized backward tracer on
    PolWater (phase 3n's kokhanovsky-backward-pol, small), each package on
    its own medium: the light curve by (c). (Its lanes' dims are held in
    tests/test_torch_backward.py, on the same medium through interop.)"""
    jt = build_pol_backward(theia_tpu, 2048)
    tt = build_pol_backward(theia_tpu_torch, 2048, "cpu")
    jh = np.asarray(jt.run()[0], np.float64)
    th = tt.run()[0].double().numpy()
    assert jh.sum() > 0 and abs(th.sum() / jh.sum() - 1.0) <= 1e-5
    assert np.abs(th - jh).max() <= 1e-5 * jh.max()
