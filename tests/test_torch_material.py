"""theia_tpu_torch.material against theia_tpu.material on the flagship's
media: the host tables, the packed store and the per-lane lookups.

Tolerance: the tables come from the same numpy code (equal, checked at
rtol 1e-6); the lookups do the same float32 ops in possibly another
order of fusion, so they agree to rtol 1e-6."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu.material as jm
import theia_tpu_torch.material as tm


def _water(mod):
    class Water(mod.WaterBaseModel, mod.HenyeyGreensteinPhaseFunction, mod.MediumModel):
        ModelName = "water"

        def __init__(self):
            mod.WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            mod.HenyeyGreensteinPhaseFunction.__init__(self, 0.9)

    return Water().createMedium(num_lambda=256, num_theta=256)


def _glass(mod):
    return mod.BK7Model().createMedium(num_lambda=256, num_theta=4)


def _materials(mod, water, glass):
    M = mod.Material
    return [
        M("glass_water", glass, water, flags="TR"),
        M("air_glass", None, glass, flags="TR"),
        M("det_water", None, water, flags="DB"),
    ]


@pytest.mark.parametrize("which", ["water", "bk7"])
def test_create_medium_tables(which):
    make = _water if which == "water" else _glass
    a, b = make(jm), make(tm)
    assert a.name == b.name
    assert float(a.lambda_min) == float(b.lambda_min)
    assert float(a.lambda_max) == float(b.lambda_max)
    for kind in tm._TABLE_PROPS:
        ja, tb = getattr(a, kind), getattr(b, kind)
        assert (ja is None) == (tb is None), kind
        if ja is not None:
            np.testing.assert_allclose(np.asarray(ja), tb, rtol=1e-6, err_msg=kind)


@pytest.fixture(scope="module")
def stores():
    js = jm.MaterialStore.pack(_materials(jm, _water(jm), _glass(jm)))
    ts = tm.MaterialStore.pack(_materials(tm, _water(tm), _glass(tm)), device="cpu")
    return js, ts


def test_material_store_pack(stores):
    js, ts = stores
    assert js.material_names == ts.material_names
    assert js.media.names == ts.media.names
    assert js.media.const4_ok == ts.media.const4_ok
    for f in ("inside", "outside", "flags_inward", "flags_outward"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy())
    for kind in js.media.tables:
        np.testing.assert_array_equal(np.asarray(js.media.tables[kind]), ts.media.tables[kind].numpy())
        np.testing.assert_array_equal(np.asarray(js.media.sizes[kind]), ts.media.sizes[kind].numpy())


@pytest.mark.parametrize("kind", ["refractive_index", "log_phase_function", "phase_sampling"])
def test_lookup_packed(stores, kind):
    js, ts = stores
    rng = np.random.default_rng(7)
    n = 4096
    handle = rng.integers(0, len(js.media.names), size=n).astype(np.int32)
    t = rng.uniform(-0.1, 1.1, size=n).astype(np.float32)  # clamped ends too
    want = jm.lookup_packed(
        js.media.tables[kind], js.media.sizes[kind], jnp.asarray(handle), jnp.asarray(t), 0.5
    )
    got = tm.lookup_packed(
        ts.media.tables[kind], ts.media.sizes[kind], torch.as_tensor(handle), torch.as_tensor(t), 0.5
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("const4", [True, False])
def test_packed_medium_constants(stores, const4):
    js, ts = stores
    if not const4:  # the four-table scalar path
        import dataclasses

        js = dataclasses.replace(js, media=dataclasses.replace(js.media, const4_ok=False))
        ts = dataclasses.replace(ts, media=dataclasses.replace(ts.media, const4_ok=False))
    rng = np.random.default_rng(11)
    n = 4096
    handle = rng.integers(0, len(js.media.names), size=n).astype(np.int32)
    lam = rng.uniform(150.0, 850.0, size=n).astype(np.float32)
    want = jm.packed_medium_constants(js.media, jnp.asarray(handle), jnp.asarray(lam))
    got = tm.packed_medium_constants(ts.media, torch.as_tensor(handle), torch.as_tensor(lam))
    for f in ("n", "vg", "mu_s", "mu_e"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", ["bk7_transmission.csv", "water_smith81.csv"])
def test_data_files_identical(name):
    root = Path(__file__).resolve().parent.parent
    assert (root / "theia_tpu_torch" / "data" / name).read_bytes() == (
        root / "theia_tpu" / "data" / name
    ).read_bytes()


@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_host_table_builders(mode):
    import theia_tpu.lookup as jl
    import theia_tpu_torch.lookup as tl

    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(200.0, 800.0, size=40))
    data = np.stack([x, np.sin(x / 50.0)], axis=-1)
    np.testing.assert_array_equal(
        tl.sample_table1d(data, 64, mode=mode), jl.sample_table1d(data, 64, mode=mode)
    )
    f = lambda a, b: a * np.exp(-b)
    np.testing.assert_array_equal(
        tl.eval_table(f, 16, (0.0, 2.0, 8)), jl.eval_table(f, 16, (0.0, 2.0, 8))
    )
