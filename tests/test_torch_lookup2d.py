"""theia_tpu_torch.lookup's 2-D tables, slopes and table handles against
theia_tpu.lookup on seeded inputs.

Tolerances and why: ``lookup_dx`` and ``lookup2d`` do the same float32 ops
in the same order as JAX's, so values and slopes agree to rtol 1e-6 (XLA
may fuse a product and a sum); the builders (``sample_table2d``,
``Table``, ``getTableSize``, ``uploadTables``) are the same numpy code and
agree exactly."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu.lookup as jl
import theia_tpu_torch.lookup as tl

torch.set_num_threads(1)
RTOL = 1e-6


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    u[:6] = [0.0, 1.0, -0.5, 1.5, 0.5, np.nextafter(np.float32(1.0), np.float32(0.0))]
    return u


@pytest.mark.parametrize("n", [1, 2, 3, 17, 256])
def test_lookup_dx_matches_jax(n):
    rng = np.random.default_rng(n)
    table = rng.normal(size=n).astype(np.float32)
    u = _coords(4096, n + 1)
    jv, jd = (np.asarray(a) for a in jl.lookup_dx(jnp.asarray(table), jnp.asarray(u)))
    tv, td = (a.numpy() for a in tl.lookup_dx(torch.as_tensor(table), torch.as_tensor(u)))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=1e-5)


def test_lookup_dx_null_table():
    u = torch.linspace(0.0, 1.0, 7)
    v, d = tl.lookup_dx(None, u, null_value=(2.5, -1.0))
    assert torch.equal(v, torch.full_like(u, 2.5)) and torch.equal(d, torch.full_like(u, -1.0))


@pytest.mark.parametrize("shape", [(2, 2), (5, 9), (33, 17), (3, 4, 6)])
def test_lookup2d_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    table = rng.normal(size=shape).astype(np.float32)
    u, v = _coords(2048, 3), _coords(2048, 4)[::-1].copy()
    want = np.asarray(jl.lookup2d(jnp.asarray(table), jnp.asarray(u), jnp.asarray(v)))
    got = tl.lookup2d(torch.as_tensor(table), torch.as_tensor(u), torch.as_tensor(v)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_lookup2d_null_and_gradient():
    u = torch.rand(16)
    assert torch.equal(tl.lookup2d(None, u, u, null_value=3.0), torch.full_like(u, 3.0))
    table = torch.arange(12, dtype=torch.float32).reshape(3, 4).requires_grad_(True)
    out = tl.lookup2d(table, torch.tensor([0.25]), torch.tensor([1.0 / 3.0]))
    out.sum().backward()
    assert abs(table.grad.sum().item() - 1.0) < 1e-6  # bilinear weights sum to one


def test_sample_table2d_axis_order_and_hull_fill():
    """tests/test_lookup.py's case: the reference's meshgrid-'xy' order and
    the nearest-neighbour fill outside the hull, equal to JAX's table."""
    x = np.array([0.0, 0.0, 10.0, 10.0])
    y = np.array([0.0, 10.0, 0.0, 10.0])
    data = np.stack([x, y, x + y], axis=-1)
    want = jl.sample_table2d(data, 100, 100, boundaries=(None, (3.0, 8.0)))
    got = tl.sample_table2d(data, 100, 100, boundaries=(None, (3.0, 8.0)))
    assert got.shape == (100, 100) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert abs(got[0].min() - 3.0) < 1e-5 and abs(got[0].max() - 13.0) < 1e-5
    assert abs(got[:, 0].min() - 3.0) < 1e-5 and abs(got[:, 0].max() - 8.0) < 1e-5

    rng = np.random.default_rng(5)
    pts = rng.random((40, 2))
    pts = pts[np.abs(pts - 0.5).sum(-1) < 0.45]  # a diamond: the corners lie outside
    dat = np.stack([pts[:, 0], pts[:, 1], pts.sum(-1)], axis=-1)
    for mode in ("linear", "cubic"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            table = tl.sample_table2d(dat, 32, 24, mode=mode)
        assert any("convex hull" in str(x.message) for x in w)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            np.testing.assert_array_equal(table, jl.sample_table2d(dat, 32, 24, mode=mode))
        assert table.shape == (24, 32) and np.isfinite(table).all()
    with pytest.raises(ValueError):
        tl.sample_table2d(dat, 8, 8, mode="quintic")


def test_aliases_table_and_upload():
    assert tl.sampleTable1D is tl.sample_table1d and tl.sampleTable2D is tl.sample_table2d
    assert tl.evalTable is tl.eval_table
    data = np.random.default_rng(2).normal(size=(7, 5))
    jt, tt = jl.Table(data), tl.Table(data)
    assert tt.shape == jt.shape and tt.nbytes == jt.nbytes == 7 * 5 * 4 + 8
    up = tt.upload(device="cpu")
    assert isinstance(up, torch.Tensor) and up.dtype == torch.float32
    np.testing.assert_array_equal(up.numpy(), np.asarray(jt.upload()))
    for a in (None, (4,), (3, 5), np.zeros((2, 3, 4))):
        assert tl.getTableSize(a) == jl.getTableSize(a)
    with pytest.raises(RuntimeError):
        tl.getTableSize(())
    tables = [np.arange(3.0), np.linspace(0.0, 1.0, 8), np.ones(1)]
    (jv, js), jh = jl.uploadTables(tables)
    (tv, ts), th = tl.uploadTables(tables, device="cpu")
    assert th == jh and tv.device.type == "cpu"
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_uploaded_tables_read_as_packed():
    """uploadTables' pair reads through lookup_packed as JAX's does."""
    import theia_tpu.material as jm
    import theia_tpu_torch.material as tm

    tables = [np.linspace(1.0, 2.0, 5), np.array([3.0, -1.0]), np.random.default_rng(1).normal(size=64)]
    (jv, js), _ = jl.uploadTables(tables)
    (tv, ts), _ = tl.uploadTables(tables, device="cpu")
    handle = np.random.default_rng(3).integers(0, 3, 1024).astype(np.int32)
    t = _coords(1024, 9)
    want = np.asarray(jm.lookup_packed(jv, js, jnp.asarray(handle), jnp.asarray(t)))
    got = tm.lookup_packed(tv, ts, torch.as_tensor(handle), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
