"""The port's table reads (``ops/table_read.py``: ``read_table`` behind
``lookup.lookup``, ``medium_constants`` and ``phase_matrix_elements``,
``read_packed`` behind ``material.lookup_packed``, the scene tracer's
Fresnel, phase and phase-matrix reads and ``packed_medium_constants``)
against ``theia_tpu``'s functions and the compositions at their call
sites, values and ``jax.vjp`` in the tables and the input. On CPU tensors
the port runs the plain versions and their written-out backward, which
the kernels of ``csrc/table_read.cu`` repeat.

Coordinates cover below 0, exactly 0, the nodes, between them, exactly 1
and above 1; tables of 1, 2, 64 and 1024 samples, packed tables shorter
than the padded width (at t = 1 the last row's slope reads the padding,
and d t sees it, as in JAX) and null tables (size 0 or None:
``null_value`` and a zero gradient). The coordinate's three forms: ``t``
itself, ``affine`` (the phase reads' ``0.5 * (cos_theta + 1)``) and
``bounds`` (the wavelength normalized by the medium's bounds, clipped once
or twice as the composition clips).

Tolerances and why:
- values: bit-equal. The same float32 ops in the same order.
- d coordinate: rtol 1e-6. One lane's chain of three to six products and
  a division, which JAX may round in another order (the const4 read sums
  four products, one a table; several tables' gradients of one input are
  summed in an order autograd chooses).
- d table: rtol 1e-5 of the largest entry. Each entry sums every lane
  that reads it; JAX scatters the value and the slope parts separately,
  the port a lane's share at once, so the sums round differently.
- At the clip's bounds JAX's max/min split a tie and pass 1/2 of the
  gradient (torch's clamp would pass 1), and 1/4 where two clips meet a
  bound: held exactly here.
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


@pytest.mark.parametrize("read", ["lookup", "lookup_packed", "packed_medium_constants"])
def test_every_lane_at_one_coordinate_matches_jax(read):
    """Every lane reads one coordinate (and one medium): each table's
    gradient takes all the lanes' shares on the same two entries, the case
    that the backward kernel's warps merge before they add."""
    rng = np.random.default_rng(7)
    n = 2048
    ct = rng.normal(size=n).astype(np.float32)
    if read == "lookup":
        table = rng.normal(size=1024).astype(np.float32)
        u = np.full(n, 0.37, np.float32)
        want, vjp = jax.vjp(lambda tab, uu: jlookup.lookup(tab, uu), jnp.asarray(table), jnp.asarray(u))
        leaves = [torch.tensor(table, requires_grad=True), torch.tensor(u, requires_grad=True)]
        got = tlookup.lookup(*leaves)
    elif read == "lookup_packed":
        values, sizes = _packed(rng, (0, 64, 17), 64)
        t, handle = np.full(n, 0.37, np.float32), np.ones(n, np.int32)
        jfn = lambda v, tt: jmat.lookup_packed(v, jnp.asarray(sizes), jnp.asarray(handle), tt, 0.25)
        want, vjp = jax.vjp(jfn, jnp.asarray(values), jnp.asarray(t))
        leaves = [torch.tensor(values, requires_grad=True), torch.tensor(t, requires_grad=True)]
        got = tmat.lookup_packed(leaves[0], torch.tensor(sizes), torch.tensor(handle), leaves[1], 0.25)
    else:
        store_j = jmat.MediumStore.pack(_media(jmat, np.random.default_rng(3)))
        store_t = tmat.MediumStore.pack(_media(tmat, np.random.default_rng(3)), device="cpu")
        lam, handle = np.full(n, 450.0, np.float32), np.ones(n, np.int32)
        jfn = lambda tab, wl: jmat.packed_medium_constants(
            dataclasses.replace(store_j, tables={**store_j.tables, "refractive_index": tab}), jnp.asarray(handle), wl).n
        want, vjp = jax.vjp(jfn, store_j.tables["refractive_index"], jnp.asarray(lam))
        leaves = [store_t.tables["refractive_index"].clone().requires_grad_(True), torch.tensor(lam, requires_grad=True)]
        store = dataclasses.replace(store_t, tables={**store_t.tables, "refractive_index": leaves[0]})
        got = tmat.packed_medium_constants(store, torch.tensor(handle), leaves[1]).n
    want_table, want_x = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.tensor(ct))
    _close(leaves[1].grad.numpy(), want_x, 1e-6)
    _close(leaves[0].grad.numpy(), want_table, 1e-5)
    assert np.count_nonzero(want_table) == 2


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


#: the coordinate's forms that the call sites use: (keyword arguments, the
#: inputs' range); wavelengths in nm against media of 300-700 and 400-500
FORMS = {
    "t": (dict(), (-0.5, 1.5)),
    "phase": (dict(affine=table_read.PHASE), (-1.0, 1.0)),
    "wavelength, one clip": (dict(clips=1), (250.0, 750.0)),
    "wavelength, two clips": (dict(clips=2), (250.0, 750.0)),
}


@pytest.mark.parametrize("channels", [1, 4])
def test_read_packed_grad_plain_matches_autograd(channels):
    """The packed read's written-out backward against torch's autograd
    through its plain forward (gathers, products, wheres, the clips and
    the coordinate's form), with one table and with four: read one by one
    and, as the const4 read, with ``shared``."""
    rng = np.random.default_rng(8 + channels)
    pad, sizes = 16, torch.tensor([0, 16, 5], dtype=torch.int32)
    lmin, lmax = torch.tensor([0.0, 300.0, 400.0]), torch.tensor([1.0, 700.0, 500.0])
    widths = (16, 16, 9, 12)[:channels]
    values = tuple(torch.tensor(rng.normal(size=(3, w)).astype(np.float32), requires_grad=True) for w in widths)
    tsizes = (sizes, torch.tensor([0, 0, 5], dtype=torch.int32), sizes, torch.tensor([0, 12, 0], dtype=torch.int32))
    nulls = (0.0, 0.0, 1.0, 0.3)[:channels]
    handle = torch.tensor(rng.integers(0, 3, 204).astype(np.int32))
    for label, (kw, (lo, hi)) in FORMS.items():
        if "wavelength" in label:
            kw = dict(kw, bounds=(lmin, lmax))
            lo, span = np.where(handle.numpy() == 1, 300.0, 400.0), np.where(handle.numpy() == 1, 400.0, 100.0)
            x = lo + span * np.concatenate([[-0.5, 0.0, 1.0, 1.5], rng.uniform(0, 1, 200)])
        else:
            x = np.concatenate([[lo - 0.5, lo, hi, hi + 0.5], rng.uniform(lo, hi, 200)])
        x = torch.tensor(x.astype(np.float32), requires_grad=True)
        for shared in (False, True) if channels > 1 else (False,):
            args = (values, tsizes[:channels], handle, x, nulls)
            if channels == 1:
                args = (values[0], sizes, handle, x, nulls[0])
            out = table_read.read_packed_plain(*args, shared=shared, **kw)
            outs = (out,) if channels == 1 else out
            cts = tuple(torch.tensor(rng.normal(size=tuple(o.shape)).astype(np.float32)) for o in outs)
            want = torch.autograd.grad(outs, (*values, x), cts)
            plain = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
            if channels > 1:
                plain[0] = tuple(v.detach() for v in values)
            got_v, got_x = table_read.read_packed_grad_plain(*plain[:4], cts[0] if channels == 1 else cts, plain[4],
                                                             shared=shared, **kw)
            got_v = (got_v,) if channels == 1 else got_v
            for g, w in zip(got_v, want[:-1]):
                _close(g.numpy(), w.numpy(), 1e-6)
            _close(got_x.numpy(), want[-1].numpy(), 1e-6)
            with torch.no_grad():
                got = table_read.read_packed(*plain, shared=shared, **kw)
            for g, o in zip((got,) if channels == 1 else got, outs):
                np.testing.assert_array_equal(g.numpy(), o.detach().numpy(), err_msg=f"{label} shared={shared}")


def test_reads_refuse_what_the_kernels_do_not_take():
    u = torch.zeros(4)
    i32 = lambda n: torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError):
        table_read.read_table(torch.zeros(4, dtype=torch.float64), u)
    with pytest.raises(ValueError):
        table_read.read_packed(torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64), torch.zeros(4), u)
    with pytest.raises(ValueError):  # five tables
        table_read.read_packed((torch.zeros(2, 3),) * 5, (i32(2),) * 5, i32(4), u, (0.0,) * 5)
    with pytest.raises(ValueError):  # four tables, three nulls
        table_read.read_packed((torch.zeros(2, 3),) * 4, (i32(2),) * 4, i32(4), u, (0.0,) * 3)
    with pytest.raises(ValueError):  # the stacked (M, L, C) table is gone: the kinds' own tables are read
        table_read.read_packed(torch.zeros(2, 3, 4), i32(2), i32(4), u, (0.0,) * 4)
    with pytest.raises(ValueError):  # tables of two stores
        table_read.read_packed((torch.zeros(2, 3), torch.zeros(3, 3)), (i32(2), i32(3)), i32(4), u)
    with pytest.raises(ValueError):  # an affine coordinate and bounds at once
        table_read.read_table(torch.zeros(4), u, affine=(0.5, 0.5), bounds=(300.0, 700.0))
    with pytest.raises(ValueError):  # the bounds are data
        table_read.read_table(torch.zeros(4, requires_grad=True), u, bounds=(torch.tensor(300.0, requires_grad=True),
                                                                             torch.tensor(700.0)))
    # a null table (None or empty) reads its null value, with no graph
    assert (tlookup.lookup(None, u, 2.0) == 2.0).all()
    assert (tlookup.lookup(torch.zeros(0, requires_grad=True), u, 3.0) == 3.0).all()
    assert (table_read.read_table((None, torch.ones(3)), u, (4.0, 0.0))[0] == 4.0).all()


def _jvp_check(jfn, tfn, inputs, cts, rtol_x=1e-6, rtol_tables=1e-5):
    """Values bit-equal, then the VJP of every input against ``jax.vjp``:
    ``inputs`` is a list of (numpy array or None, is_coordinate); ``jfn``
    and ``tfn`` take the arrays (None stays None) and return a tuple of
    outputs."""
    live = [a for a, _ in inputs if a is not None]
    want, vjp = jax.vjp(lambda *a: tuple(jfn(*a)), *[jnp.asarray(a) for a in live])
    want_grads = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = [torch.tensor(a, requires_grad=True) for a in live]
    it = iter(leaves)
    got = tfn(*[None if a is None else next(it) for a, _ in inputs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    torch.autograd.backward(list(got), [torch.tensor(c) for c in cts])
    coords = [is_x for a, is_x in inputs if a is not None]
    for leaf, w, is_x in zip(leaves, want_grads, coords):
        _close(leaf.grad.numpy(), np.asarray(w), rtol_x if is_x else rtol_tables)
    return leaves


def _lambda_lanes(rng, bounds, per=120):
    """Wavelengths a medium: below, at and above its bounds, nine nodes and
    uniform draws; returns (lambda, handle)."""
    lam, handle = [], []
    for h, (lo, hi) in enumerate(bounds):
        lam.append(np.concatenate([[lo - 10.0, lo, hi, hi + 10.0], lo + (hi - lo) * np.linspace(0.0, 1.0, 9),
                                   rng.uniform(lo - 5.0, hi + 5.0, per)]))
        handle.append(np.full(lam[-1].size, h, np.int32))
    return np.concatenate(lam).astype(np.float32), np.concatenate(handle)


@pytest.mark.parametrize("site", ["fresnel", "scatter_prob", "sample_phase"])
def test_read_packed_forms_match_jax(site):
    """One packed table read at a call site's coordinate, formed in the
    read: ``_fresnel``'s n_t at (lambda - lmin) / (lmax - lmin) clipped
    twice (``theia_tpu/trace/scene.py:291-300``), ``_scatter_prob_packed``'s
    log phase at 0.5 * (cos + 1) (l.315-321), ``_sample_phase_packed``'s
    table at u itself (l.331); against the JAX composition."""
    rng = np.random.default_rng(31)
    values, sizes = _packed(rng, (0, 64, 17, 1, 2), 64)
    lmin = np.array([0.0, 300.0, 400.0, 350.0, 500.0], np.float32)
    lmax = np.array([1.0, 700.0, 500.0, 650.0, 600.0], np.float32)
    if site == "fresnel":
        x, handle = _lambda_lanes(rng, list(zip(lmin, lmax)))
        jt = lambda xx: jnp.clip((xx - jnp.take(lmin, handle)) / (jnp.take(lmax, handle) - jnp.take(lmin, handle)),
                                 0.0, 1.0)
        kw, null = dict(bounds=(torch.tensor(lmin), torch.tensor(lmax)), clips=2), 1.0
    else:
        lo, hi = (-1.0, 1.0) if site == "scatter_prob" else (0.0, 1.0)
        x = np.concatenate([[lo - 0.25, lo, hi, hi + 0.25], rng.uniform(lo, hi, 600)]).astype(np.float32)
        handle = rng.integers(0, 5, x.size).astype(np.int32)
        jt = (lambda xx: 0.5 * (xx + 1.0)) if site == "scatter_prob" else (lambda xx: xx)
        kw, null = (dict(affine=table_read.PHASE) if site == "scatter_prob" else {}), -2.53
    ct = rng.normal(size=x.size).astype(np.float32)
    _jvp_check(lambda v, xx: (jmat.lookup_packed(v, jnp.asarray(sizes), jnp.asarray(handle), jt(xx), null),),
               lambda v, xx: (table_read.read_packed(v, torch.tensor(sizes), torch.tensor(handle), xx, null, **kw),),
               [(values, False), (x, True)], [ct])


def test_two_clips_take_a_quarter_of_the_gradient():
    """At a medium's bounds ``_fresnel``'s clip and the read's own each pass
    1/2 of the gradient, as ``jax.grad`` of the composition gives: 1/4."""
    values = np.array([[0.0, 0.0, 0.0], [1.0, 3.0, 0.0]], np.float32)  # medium 1: 2 of 3 columns
    sizes, handle = np.array([0, 2], np.int32), np.ones(3, np.int32)
    lmin, lmax = np.array([0.0, 400.0], np.float32), np.array([1.0, 500.0], np.float32)
    lam = np.array([400.0, 500.0, 450.0], np.float32)

    def jfn(xx):
        t = jnp.clip((xx - jnp.take(lmin, handle)) / (jnp.take(lmax, handle) - jnp.take(lmin, handle)), 0.0, 1.0)
        return jmat.lookup_packed(jnp.asarray(values), jnp.asarray(sizes), jnp.asarray(handle), t, 1.0).sum()

    want = np.asarray(jax.grad(jfn)(jnp.asarray(lam)))
    np.testing.assert_array_equal(want, np.float32([0.25 * 2.0, 0.25 * -3.0, 2.0]) / np.float32(100.0))
    leaf = torch.tensor(lam, requires_grad=True)
    table_read.read_packed(torch.tensor(values), torch.tensor(sizes), torch.tensor(handle), leaf, 1.0,
                           bounds=(torch.tensor(lmin), torch.tensor(lmax)), clips=2).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), want)


def _phase_store(pkg, rng, null_m34: bool):
    """A store of two media with the four phase-matrix tables (33 and 17
    samples; the second medium's m34 null where asked) and one without."""
    mat = pkg
    arr = jnp.asarray if mat is jmat else (lambda a: a)
    media = []
    for name, n in (("a", 33), ("b", 17), ("c", 0)):
        tables = {} if n == 0 else {f"phase_{k}": arr(rng.uniform(-1, 1, n).astype(np.float32))
                                    for k in ("m12", "m22", "m33", "m34")}
        if name == "b" and null_m34:
            tables.pop("phase_m34")
        media.append(mat.Medium(300.0, 700.0, name=name, **tables))
    return mat.MediumStore.pack(media) if mat is jmat else mat.MediumStore.pack(media, device="cpu")


def test_phase_matrix_read_is_four_reads():
    """The polarized phase matrix (``trace/scene.py`` ``_phase_matrix_packed``):
    one read of four packed tables equals four one-table reads bit for
    bit, and ``theia_tpu``'s function, values and VJP."""
    from theia_tpu.trace.scene import _phase_matrix_packed as j_phase
    from theia_tpu_torch.trace.scene import _phase_matrix_packed as t_phase

    kinds = ("phase_m12", "phase_m22", "phase_m33", "phase_m34")
    store_j, store_t = (_phase_store(pkg, np.random.default_rng(5), True) for pkg in (jmat, tmat))
    rng = np.random.default_rng(6)
    cos = np.concatenate([[-1.25, -1.0, 1.0, 1.25], rng.uniform(-1, 1, 500)]).astype(np.float32)
    handle = rng.integers(0, 4, cos.size).astype(np.int32)
    one_by_one = [tmat.lookup_packed(store_t.tables[k], store_t.sizes[k], torch.tensor(handle),
                                     0.5 * (torch.tensor(cos) + 1.0), 0.0) for k in kinds]
    for got, want in zip(t_phase(store_t, torch.tensor(handle), torch.tensor(cos)), one_by_one):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    cts = [rng.normal(size=cos.size).astype(np.float32) for _ in kinds]

    def jfn(*a):
        store = dataclasses.replace(store_j, tables={**store_j.tables, **dict(zip(kinds, a[:4]))})
        return j_phase(store, jnp.asarray(handle), a[4])

    def tfn(*a):
        store = dataclasses.replace(store_t, tables={**store_t.tables, **dict(zip(kinds, a[:4]))})
        return t_phase(store, torch.tensor(handle), a[4])

    leaves = _jvp_check(jfn, tfn, [(np.asarray(store_j.tables[k]), False) for k in kinds] + [(cos, True)], cts)
    assert not leaves[3][2].any()  # medium b's null m34 takes no gradient


@pytest.mark.parametrize("null_kind", [None, "scattering_coef"])
def test_medium_constants_read_matches_jax(null_kind):
    """``medium_constants``: the four tables of one medium (1024, 64, 64
    and 2 samples; one of them None where asked) in one read at the
    wavelength normalized and clipped, which each read clips again: values
    bit-equal, VJP in the tables and the wavelength against
    ``theia_tpu.material.medium_constants`` (at the bounds 1/4)."""
    rng = np.random.default_rng(12)
    kinds = ("absorption_coef", "scattering_coef", "refractive_index", "group_velocity")
    tables = {k: rng.uniform(0.5, 1.5, n).astype(np.float32) for k, n in zip(kinds, (1024, 64, 64, 2))}
    if null_kind:
        tables[null_kind] = None
    lam, _ = _lambda_lanes(rng, [(350.0, 650.0)], 400)
    cts = [rng.normal(size=lam.size).astype(np.float32) for _ in range(4)]
    fields = ("n", "vg", "mu_s", "mu_e")

    def jfn(*a):
        it = iter(a[:-1])
        c = jmat.medium_constants(jmat.Medium(350.0, 650.0, **{k: None if tables[k] is None else next(it)
                                                                 for k in kinds}), a[-1])
        return tuple(getattr(c, f) for f in fields)

    def tfn(*a):
        it = iter(a[:-1])
        medium = tmat.Medium(350.0, 650.0, **{k: None if tables[k] is None else next(it) for k in kinds}).to("cpu")
        medium = dataclasses.replace(medium, **{k: v for k, v in zip([k for k in kinds if tables[k] is not None],
                                                                      a[:-1])})
        c = tmat.medium_constants(medium, a[-1])
        return tuple(getattr(c, f) for f in fields)

    _jvp_check(jfn, tfn, [(tables[k], False) for k in kinds if tables[k] is not None] + [(lam, True)], cts)


def test_phase_matrix_elements_read_matches_jax():
    """``polarization.phase_matrix_elements``: four tables, one of them
    None, in one read at 0.5 * (cos + 1): values bit-equal and the VJP
    against ``theia_tpu.polarization``'s."""
    import theia_tpu.polarization as jpol
    import theia_tpu_torch.polarization as tpol

    rng = np.random.default_rng(13)
    kinds = ("phase_m12", "phase_m22", "phase_m33")
    tables = [rng.uniform(-1, 1, n).astype(np.float32) for n in (33, 64, 2)]
    cos = np.concatenate([[-1.5, -1.0, 1.0, 1.5], rng.uniform(-1, 1, 400)]).astype(np.float32)
    cts = [rng.normal(size=cos.size).astype(np.float32) for _ in range(4)]
    _jvp_check(lambda *a: jpol.phase_matrix_elements(jmat.Medium(300.0, 700.0, **dict(zip(kinds, a[:3]))), a[3]),
               lambda *a: tpol.phase_matrix_elements(tmat.Medium(300.0, 700.0, **dict(zip(kinds, a[:3]))), a[3]),
               [(t, False) for t in tables] + [(cos, True)], cts)


def test_packed_constants_without_const4_match_jax():
    """``packed_medium_constants`` of a store whose tables differ in length
    within a medium (no ``const4_ok``): four reads' worth in one launch, at
    the wavelength clipped and clipped again; values and VJP against
    ``theia_tpu``'s four ``lookup_packed`` reads."""
    rng = np.random.default_rng(14)
    kinds = tmat._CONST4_KINDS

    def media(mat):
        r = np.random.default_rng(15)
        arr = jnp.asarray if mat is jmat else (lambda a: a)
        return [mat.Medium(300.0, 700.0, name="a", **{k: arr(r.uniform(0.5, 1.5, n).astype(np.float32))
                                                      for k, n in zip(kinds, (64, 32, 64, 2))}),
                mat.Medium(400.0, 500.0, name="b", absorption_coef=arr(r.uniform(0.5, 1.5, 8).astype(np.float32)))]

    store_j, store_t = jmat.MediumStore.pack(media(jmat)), tmat.MediumStore.pack(media(tmat), device="cpu")
    assert not store_j.const4_ok and not store_t.const4_ok
    lam, handle = _lambda_lanes(rng, [(300.0, 700.0), (300.0, 700.0), (400.0, 500.0)], 100)
    cts = [rng.normal(size=lam.size).astype(np.float32) for _ in range(4)]
    fields = ("n", "vg", "mu_s", "mu_e")

    def jfn(*a):
        store = dataclasses.replace(store_j, tables={**store_j.tables, **dict(zip(kinds, a[:4]))})
        c = jmat.packed_medium_constants(store, jnp.asarray(handle), a[4])
        return tuple(getattr(c, f) for f in fields)

    def tfn(*a):
        store = dataclasses.replace(store_t, tables={**store_t.tables, **dict(zip(kinds, a[:4]))})
        c = tmat.packed_medium_constants(store, torch.tensor(handle), a[4])
        return tuple(getattr(c, f) for f in fields)

    _jvp_check(jfn, tfn, [(np.asarray(store_j.tables[k]), False) for k in kinds] + [(lam, True)], cts)


def test_tables_edited_in_place_and_replaced_are_read_anew():
    """A table set is validated once and then found by its tensors: a
    table edited in place is read as it is now, a store replaced by
    ``dataclasses.replace`` with other tables, and a view of the same
    storage with another shape, each get a set of their own."""
    store = tmat.MediumStore.pack(_media(tmat, np.random.default_rng(3)), device="cpu")
    handle = torch.tensor([1, 2, 3, 0, 1], dtype=torch.int32)
    lam = torch.tensor([500.0, 450.0, 400.0, 500.0, 310.0])
    first = tmat.packed_medium_constants(store, handle, lam)
    readers = dict(table_read._READERS)
    with torch.no_grad():
        store.tables["refractive_index"].mul_(2.0)
    again = tmat.packed_medium_constants(store, handle, lam)
    assert dict(table_read._READERS) == readers  # the same set, read anew
    np.testing.assert_array_equal(again.n.numpy()[:3], 2.0 * first.n.numpy()[:3])
    np.testing.assert_array_equal(again.vg.numpy(), first.vg.numpy())
    other = dataclasses.replace(store, tables={**store.tables, "group_velocity": store.tables["group_velocity"] + 1.0})
    replaced = tmat.packed_medium_constants(other, handle, lam)
    np.testing.assert_array_equal(replaced.vg.numpy()[[0, 2]], first.vg.numpy()[[0, 2]] + 1.0)
    np.testing.assert_array_equal(replaced.vg.numpy()[[1, 3]], first.vg.numpy()[[1, 3]])  # b's and vacuum's nulls
    table = torch.arange(8.0)
    u = torch.tensor([0.5, 1.0])
    np.testing.assert_array_equal(table_read.read_table(table, u).numpy(), [3.5, 7.0])
    np.testing.assert_array_equal(table_read.read_table(table[:4], u).numpy(), [1.5, 3.0])
