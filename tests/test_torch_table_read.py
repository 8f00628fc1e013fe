"""The port's table reads (``ops/table_read.py``: ``read_table`` behind
``lookup.lookup``, ``read_packed`` behind ``material.lookup_packed`` and,
with four channels, the const4 read of
``material.packed_medium_constants``) against ``theia_tpu``'s functions,
values and ``jax.vjp`` in the table and the coordinate. On CPU tensors
the port runs the plain versions and their written-out backward, which
the kernels of ``csrc/table_read.cu`` repeat.

Coordinates cover below 0, exactly 0, the nodes, between them, exactly 1
and above 1; tables of 1, 2, 64 and 1024 samples, packed tables shorter
than the padded width (at t = 1 the last row's slope reads the padding,
and d t sees it, as in JAX) and null tables (size 0: ``null_value`` and
a zero gradient).

Tolerances and why:
- values: bit-equal. The same float32 ops in the same order.
- d coordinate: rtol 1e-6. One lane's chain of three or four products,
  which JAX may round in another order (the const4 read sums four
  products, one a channel).
- d table: rtol 1e-5 of the largest entry. Each entry sums every lane
  that reads it; JAX scatters the value and the slope parts separately,
  the port a lane's share at once, so the sums round differently.
- At the clip's bounds JAX's max/min split a tie and pass 1/2 of the
  gradient (torch's clamp would pass 1): held exactly here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu.lookup as jlookup
import theia_tpu.material as jmat
import theia_tpu_torch.lookup as tlookup
import theia_tpu_torch.material as tmat
from theia_tpu_torch.ops import table_read

torch.set_num_threads(1)


def _coords(n_table, rng, n=300):
    """Seeded u: below 0, 0, every node (up to 64 of them), midpoints,
    1, above 1 and uniform draws."""
    nodes = np.arange(n_table, dtype=np.float32) / np.float32(max(n_table - 1, 1))
    special = np.concatenate([[-0.3, -0.0, 0.0, 1.0, 1.25], nodes[:64], nodes[-3:], (nodes[:-1] + nodes[1:])[:32] / 2])
    return np.concatenate([special, rng.uniform(-0.1, 1.1, n)]).astype(np.float32)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n_table", [1, 2, 64, 1024])
def test_read_table_matches_jax(n_table):
    rng = np.random.default_rng(n_table)
    table = rng.normal(size=n_table).astype(np.float32)
    u = _coords(n_table, rng)
    ct = rng.normal(size=u.size).astype(np.float32)
    want, vjp = jax.vjp(lambda tab, uu: jlookup.lookup(tab, uu), jnp.asarray(table), jnp.asarray(u))
    want_table, want_u = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    leaf_t, leaf_u = torch.tensor(table, requires_grad=True), torch.tensor(u, requires_grad=True)
    got = tlookup.lookup(leaf_t, leaf_u)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.tensor(ct))
    _close(leaf_u.grad.numpy(), want_u, 1e-6)
    _close(leaf_t.grad.numpy(), want_table, 1e-5)
    assert table_read.read_table.launches == table_read.read_table_grad.launches == 0


def test_clip_bounds_take_half_the_gradient():
    """d/du at u = 0 and u = 1 where the lerp has a slope there (a packed
    table's first and padded last row): JAX passes 1/2 through the clip.
    For one table the slope at a node is 0 (floor = ceil), so d/du is 0
    at both bounds, also in JAX."""
    values = np.array([[0.0, 0.0, 0.0], [1.0, 3.0, 0.0]], np.float32)  # medium 1: 2 of 3 columns
    sizes = np.array([0, 2], np.int32)
    t = np.array([0.0, 1.0, 0.5], np.float32)
    handle = np.ones(3, np.int32)
    want = jax.grad(lambda tt: jmat.lookup_packed(jnp.asarray(values), jnp.asarray(sizes), jnp.asarray(handle), tt).sum())(
        jnp.asarray(t)
    )
    leaf = torch.tensor(t, requires_grad=True)
    tmat.lookup_packed(torch.tensor(values), torch.tensor(sizes), torch.tensor(handle), leaf).sum().backward()
    np.testing.assert_array_equal(np.asarray(want), [1.0, -1.5, 2.0])
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(want))
    g = jax.grad(lambda uu: jlookup.lookup(jnp.arange(4.0), uu).sum())(jnp.asarray([0.0, 1.0]))
    leaf = torch.tensor([0.0, 1.0], requires_grad=True)
    tlookup.lookup(torch.arange(4.0), leaf).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(g))


def _packed(rng, lengths, width):
    values = np.zeros((len(lengths), width), np.float32)
    for m, n in enumerate(lengths):
        values[m, :n] = rng.normal(size=n)
    return values, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths,width", [((0, 64, 17, 1, 2), 64), ((0, 1024, 1000), 1024), ((0, 2), 2)])
def test_read_packed_matches_jax(lengths, width):
    rng = np.random.default_rng(width + len(lengths))
    values, sizes = _packed(rng, lengths, width)
    t = np.concatenate([_coords(n, rng, 100) for n in lengths])
    handle = np.concatenate([np.full(_coords(n, rng, 100).size, m, np.int32) for m, n in enumerate(lengths)])
    ct = rng.normal(size=t.size).astype(np.float32)

    def jfn(v, tt):
        return jmat.lookup_packed(v, jnp.asarray(sizes), jnp.asarray(handle), tt, 0.25)

    want, vjp = jax.vjp(jfn, jnp.asarray(values), jnp.asarray(t))
    want_values, want_t = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    leaf_v, leaf_t = torch.tensor(values, requires_grad=True), torch.tensor(t, requires_grad=True)
    got = tmat.lookup_packed(leaf_v, torch.tensor(sizes), torch.tensor(handle), leaf_t, 0.25)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert (got.detach().numpy()[handle == 0] == 0.25).all()
    got.backward(torch.tensor(ct))
    _close(leaf_t.grad.numpy(), want_t, 1e-6)
    _close(leaf_v.grad.numpy(), want_values, 1e-5)
    # null tables take no gradient; a padded table's padding none either,
    # but for a table of one sample, whose t scales by max(n - 1, 1) = 1:
    # it interpolates towards the padding, in JAX as in the port
    assert not leaf_v.grad[0].any() and not leaf_t.grad[torch.tensor(handle == 0)].any()
    for m, n in enumerate(lengths):
        assert not leaf_v.grad[m, max(n, 2):].any()
        assert bool(leaf_v.grad[m, 1].any()) == (n > 0)


def _media(pkg, rng):
    """Three media whose four constants tables are each 64 samples, 2
    samples with two of them null, and 1024 samples: ``const4_ok``."""
    mat = pkg.material if hasattr(pkg, "material") else pkg
    arr = (lambda a: jnp.asarray(a)) if mat is jmat else (lambda a: a)
    tabs = []
    for name, n, kinds in (
        ("a", 64, ("absorption_coef", "scattering_coef", "refractive_index", "group_velocity")),
        ("b", 2, ("absorption_coef", "refractive_index")),
        ("c", 1024, ("absorption_coef", "scattering_coef", "refractive_index", "group_velocity")),
    ):
        tabs.append((name, {k: rng.uniform(0.5, 1.5, size=n).astype(np.float32) for k in kinds}))
    lam = {"a": (300.0, 700.0), "b": (400.0, 500.0), "c": (350.0, 650.0)}
    return [mat.Medium(*lam[name], name=name, **{k: arr(v) for k, v in t.items()}) for name, t in tabs]


def test_const4_read_matches_jax():
    media_j = _media(jmat, np.random.default_rng(3))
    media_t = _media(tmat, np.random.default_rng(3))
    store_j = jmat.MediumStore.pack(media_j)
    store_t = tmat.MediumStore.pack(media_t, device="cpu")
    assert store_j.const4_ok and store_t.const4_ok
    rng = np.random.default_rng(4)
    bounds = [(300.0, 700.0), (400.0, 500.0), (350.0, 650.0)]
    lam, handle = [], []
    for h, (lo, hi) in enumerate(bounds, start=1):
        nodes = lo + (hi - lo) * np.linspace(0.0, 1.0, 9)
        lam.append(np.concatenate([[lo - 10.0, lo, hi, hi + 10.0], nodes, rng.uniform(lo - 5, hi + 5, 80)]))
        handle.append(np.full(lam[-1].size, h, np.int32))
    lam.append(rng.uniform(300.0, 700.0, 20))  # vacuum lanes read the null row
    handle.append(np.zeros(20, np.int32))
    lam, handle = np.concatenate(lam).astype(np.float32), np.concatenate(handle)
    kinds = tmat._CONST4_KINDS
    cts = {k: rng.normal(size=lam.size).astype(np.float32) for k in ("n", "vg", "mu_s", "mu_e")}

    def jfn(tables, wl):
        store = dataclasses.replace(store_j, tables={**store_j.tables, **tables})
        c = jmat.packed_medium_constants(store, jnp.asarray(handle), wl)
        return {k: getattr(c, k) for k in cts}

    want, vjp = jax.vjp(jfn, {k: store_j.tables[k] for k in kinds}, jnp.asarray(lam))
    want_tables, want_lam = vjp({k: jnp.asarray(v) for k, v in cts.items()})
    leaves = {k: store_t.tables[k].clone().requires_grad_(True) for k in kinds}
    leaf_lam = torch.tensor(lam, requires_grad=True)
    store = dataclasses.replace(store_t, tables={**store_t.tables, **leaves})
    got = tmat.packed_medium_constants(store, torch.tensor(handle), leaf_lam)
    for k in cts:
        np.testing.assert_array_equal(getattr(got, k).detach().numpy(), np.asarray(want[k]), err_msg=k)
    torch.autograd.backward([getattr(got, k) for k in cts], [torch.tensor(v) for v in cts.values()])
    _close(leaf_lam.grad.numpy(), np.asarray(want_lam), 1e-6)
    for k in kinds:
        _close(leaves[k].grad.numpy(), np.asarray(want_tables[k]), 1e-5)
        assert not leaves[k].grad[0].any()  # vacuum
    # medium b's null tables read their defaults and take no gradient
    assert not leaves["scattering_coef"].grad[2].any() and not leaves["group_velocity"].grad[2].any()


@pytest.mark.parametrize("channels", [1, 4])
def test_read_packed_grad_plain_matches_autograd(channels):
    """The packed read's written-out backward against torch's autograd
    through its plain forward (gathers, a product, a where, the clip),
    with one channel and with the const4 read's four."""
    rng = np.random.default_rng(8 + channels)
    pad, sizes = 16, torch.tensor([0, 16, 5], dtype=torch.int32)
    shape = (3, pad, channels) if channels > 1 else (3, pad)
    values = torch.tensor(rng.normal(size=shape).astype(np.float32), requires_grad=True)
    t = torch.tensor(np.concatenate([[-0.5, 0.0, 1.0, 1.5], rng.uniform(0, 1, 200)]).astype(np.float32),
                     requires_grad=True)
    handle = torch.tensor(rng.integers(0, 3, t.shape[0]).astype(np.int32))
    nulls = (0.0, 0.0, 1.0, 0.3)[:channels] if channels > 1 else 0.3
    out = table_read.read_packed_plain(values, sizes, handle, t, nulls)
    ct = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32))
    want = torch.autograd.grad(out, (values, t), ct)
    got = table_read.read_packed_grad_plain(values.detach(), sizes, handle, t.detach(), ct)
    _close(got[0].numpy(), want[0].numpy(), 1e-6)
    _close(got[1].numpy(), want[1].numpy(), 1e-6)
    np.testing.assert_array_equal(table_read.read_packed(values.detach(), sizes, handle, t.detach(), nulls).numpy(),
                                  out.detach().numpy())


def test_reads_refuse_what_the_kernels_do_not_take():
    u = torch.zeros(4)
    with pytest.raises(ValueError):
        table_read.read_table(torch.zeros(4, dtype=torch.float64), u)
    with pytest.raises(ValueError):
        table_read.read_packed(torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64), torch.zeros(4), u)
    with pytest.raises(ValueError):
        table_read.read_packed(torch.zeros(2, 3, 5), torch.zeros(2, dtype=torch.int32), torch.zeros(4), u, (0.0,) * 5)
    with pytest.raises(ValueError):
        table_read.read_packed(torch.zeros(2, 3, 4), torch.zeros(2, dtype=torch.int32), torch.zeros(4), u, (0.0,) * 3)
    # a null table (None or empty) reads its null value, with no graph
    assert (tlookup.lookup(None, u, 2.0) == 2.0).all()
    assert (tlookup.lookup(torch.zeros(0, requires_grad=True), u, 3.0) == 3.0).all()
