"""The hit reconstruction's row gathers with ``columns=``
(``ops/table_read.gather_rows``): one output a span of the row, the
integer columns converted, and a backward that takes the spans' gradients
alone. Held against ``jnp.take`` and its slices (``theia_tpu.accel``'s
composition, values and ``jax.vjp``), against plain torch indexing, and
in ``accel._reconstruct_hit`` against the composition it replaces (one
(N, 32) gather sliced into pieces). On CPU tensors the port runs the
plain versions, which the kernels of ``csrc/table_read.cu`` repeat; the
card's kernels are held to them by ``chip_smoke.py`` (``check_gather_rows``).

Tolerances and why:
- values: bit-equal. A gather copies, and the integer columns convert as
  ``.to(torch.int32)`` and ``astype(jnp.int32)`` do.
- gradients: rtol 1e-6. Each table entry sums the lanes that read it;
  ``index_add_``, torch's index backward and JAX's scatter-add may sum
  them in other orders.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import theia_tpu_torch
from theia_tpu_torch import accel
from theia_tpu_torch.accel import INST_COLUMNS, TRI_COLUMNS
from theia_tpu_torch.ops.table_read import (
    gather_rows, gather_rows_grad, gather_rows_grad_plain, gather_rows_plain,
)
from backward_ops import count
from torch_flagship import build_flagship, icosphere

torch.set_num_threads(1)

N_LANES = 700


@pytest.fixture(scope="module")
def pack():
    """The brute-force flagship's scene pack on a small icosphere (240
    ``tri_data`` rows, 3 ``inst_data`` rows)."""
    return build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="auto", device="cpu").scene.pack


def _table(pack, name):
    """The table, its columns and seeded row indices (half of them on the
    detector's rows for ``tri_data``, as a shadow query's winners are)."""
    rng = np.random.default_rng(11)
    table = getattr(pack, name)
    if name == "tri_data":
        det = np.nonzero(table[:, 27].numpy() == 2)[0]
        rows = np.where(rng.uniform(size=N_LANES) < 0.5, rng.choice(det, N_LANES),
                        rng.integers(0, table.shape[0], N_LANES))
        return table, TRI_COLUMNS, torch.as_tensor(rows.astype(np.int32))
    return table, INST_COLUMNS, torch.as_tensor(rng.integers(0, table.shape[0], N_LANES).astype(np.int32))


def _floats(columns):
    return [k for k, span in enumerate(columns) if len(span) == 2]


@pytest.mark.parametrize("name", ["tri_data", "inst_data"])
def test_pieces_bit_equal_to_row_slices(pack, name):
    """Every piece is ``table[index][:, a:b]`` bit for bit (converted where
    the span is an integer one), and so is ``jnp.take``'s slice; without
    ``columns`` the whole rows."""
    table, columns, index = _table(pack, name)
    rows = table[index.long()]
    j_rows = np.asarray(jnp.take(jnp.asarray(table.numpy()), jnp.asarray(index.numpy()), axis=0))
    pieces = gather_rows(table, index, columns=columns)
    assert len(pieces) == len(columns)
    for piece, (start, stop, *kind) in zip(pieces, columns):
        want = rows[:, start:stop]
        j_want = j_rows[:, start:stop]
        if kind:
            want, j_want = want.to(torch.int32), j_want.astype(np.int32)
        assert piece.dtype == want.dtype and piece.is_contiguous()
        assert torch.equal(piece, want), (start, stop)
        np.testing.assert_array_equal(piece.numpy(), j_want)
    assert torch.equal(gather_rows(table, index), rows)
    for got, want in zip(gather_rows_plain(table, index, columns), pieces):
        assert torch.equal(got, want)


@pytest.mark.parametrize(
    "name, used",
    [("tri_data", (0, 4, 6, 8)), ("tri_data", (0, 1, 2, 3, 4, 5, 6, 7, 8)), ("inst_data", (0,)), ("inst_data", (0, 1))],
)
def test_pieces_gradient_matches_indexing_and_jax(pack, name, used):
    """A loss over some of the float pieces, the others unused (their
    gradients arrive as None): the table's gradient equals autograd through
    plain indexing and ``jax.vjp`` of ``jnp.take``'s slices, rtol 1e-6."""
    table, columns, index = _table(pack, name)
    rng = np.random.default_rng(12)
    weights = {k: rng.normal(size=(N_LANES, columns[k][1] - columns[k][0])).astype(np.float32) for k in used}

    def loss(pieces):
        return sum((pieces[k] * torch.as_tensor(w)).sum() for k, w in weights.items())

    leaf = table.clone().requires_grad_(True)
    loss(gather_rows(leaf, index, columns=columns)).backward()
    ref = table.clone().requires_grad_(True)
    rows = ref[index.long()]
    loss([rows[:, span[0]:span[1]] for span in columns]).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy(), rtol=1e-6, atol=1e-6)

    def j_pieces(t):
        r = jnp.take(t, jnp.asarray(index.numpy()), axis=0)
        return [r[:, columns[k][0]:columns[k][1]] for k in used]

    _, vjp = jax.vjp(j_pieces, jnp.asarray(table.numpy()))
    (j_grad,) = vjp([jnp.asarray(weights[k]) for k in used])
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(j_grad), rtol=1e-6, atol=1e-6)
    unused = [k for k in _floats(columns) if k not in used]
    for k in unused:  # an unused span adds nothing
        assert not leaf.grad[:, columns[k][0]:columns[k][1]].any()


@pytest.mark.parametrize("name", ["tri_data", "inst_data"])
def test_integer_pieces_carry_no_gradient(pack, name):
    """The integer pieces take no gradient: they do not require one on a
    graph-carrying table, and ``gather_rows_grad`` ignores a gradient
    given for them."""
    table, columns, index = _table(pack, name)
    pieces = gather_rows(table.clone().requires_grad_(True), index, columns=columns)
    for piece, span in zip(pieces, columns):
        assert piece.requires_grad == (len(span) == 2), span
    grads = [torch.ones(N_LANES, span[1] - span[0]) for span in columns]
    got = gather_rows_grad(table.shape, index, grads, columns)
    ints = [k for k in range(len(columns)) if k not in _floats(columns)]
    for k in ints:
        assert not got[:, columns[k][0]:columns[k][1]].any()
    assert torch.equal(got, gather_rows_grad_plain(table.shape, index, grads, columns))
    # the (N, W) form: index_add_ of the whole rows' gradient
    full = torch.ones(N_LANES, table.shape[1])
    want = torch.zeros_like(table).index_add_(0, index, full)
    assert torch.equal(gather_rows_grad(table.shape, index, full), want)


@pytest.mark.parametrize("span", [(0, 33), (5, 5), (-1, 3), (0, 3, torch.float64), (0, 3, torch.int32, 1), (2, 4),
                                  (1, 2), [3, 6]])
def test_gather_rows_refuses_bad_spans(pack, span):
    """Out of the row, empty, of another type, overlapping (columns 2 or 1
    shared with (0, 3): the kernel's backward stages a row's spans into one
    tile, where the plain version adds them), or not hashable."""
    with pytest.raises(ValueError):
        gather_rows(pack.tri_data, torch.zeros(4, dtype=torch.int32), columns=((0, 3), span))
    with pytest.raises(ValueError):
        gather_rows(pack.tri_data, torch.zeros(4, dtype=torch.int32), columns=[(0, 3)])
    with pytest.raises(ValueError):
        gather_rows(pack.tri_data, torch.zeros(4, dtype=torch.int32), columns=((0, 1),) * 17)


def _rays(n, seed):
    """Rays from around the glass shells (centred at (3, 0, 0)) and the
    detector (at (0, 3, 0)), every other one each, aimed near its centre:
    most hit, some miss."""
    rng = np.random.default_rng(seed)
    centre = np.where(np.arange(n)[:, None] % 2 == 0, [3.0, 0.0, 0.0], [0.0, 3.0, 0.0])
    o = centre + rng.normal(0.0, 1.5, (n, 3))
    d = centre + rng.normal(0.0, 0.6, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return torch.zeros(n, dtype=torch.int32), *(torch.as_tensor(a.astype(np.float32)) for a in (o, d))


def _moved(pack):
    """The pack with the detector moved by ``translate_instance`` along a
    leaf: ``tri_data`` and ``inst_data`` carry its graph."""
    shift = torch.tensor([0.01, -0.02, 0.005], requires_grad=True)
    return pack.translate_instance(2, shift), shift


def _sliced_rows(table, index, columns=None):
    """The composition that ``gather_rows(..., columns=)`` replaces in the
    reconstruction: one (N, 32) gather, then a slice of it a piece."""
    rows = table[index.long()]
    return tuple(rows[:, s[0]:s[1]].to(torch.int32) if len(s) == 3 else rows[:, s[0]:s[1]] for s in columns)


def _hit_loss(hit):
    return (hit.world_pos.sum() + hit.ray_nrm.sum() + hit.obj_pos.sum() + torch.where(hit.valid, hit.t, 0.0).sum()
            + hit.world_to_obj.sum())


def test_reconstructed_hit_bit_equal_to_sliced_rows(pack, monkeypatch):
    """``_reconstruct_hit`` from the pieces gives the hit that slicing one
    (N, 32) gather a table gave, every field bit for bit, and the same
    gradient in the detector's shift (rtol 1e-6); the query's rows, taken
    as views where nothing is differentiated, give it too."""
    medium, o, d = _rays(N_LANES, 13)
    moved, shift = _moved(pack)
    hit = accel.intersect_scene(moved, medium, o, d, torch.inf)
    (grad,) = torch.autograd.grad(_hit_loss(hit), shift)
    monkeypatch.setattr(accel, "gather_rows", _sliced_rows)
    moved_ref, shift_ref = _moved(pack)
    ref = accel.intersect_scene(moved_ref, medium, o, d, torch.inf)
    (grad_ref,) = torch.autograd.grad(_hit_loss(ref), shift_ref)
    monkeypatch.undo()
    assert hit.valid.sum() > 100 and (~hit.valid).sum() > 10 and (hit.instance[hit.valid] == 2).sum() > 100
    assert grad.abs().min() > 0
    from_query = accel.intersect_scene(pack, medium, o, d, torch.inf)
    leaf = dataclasses.replace(pack, tri_data=pack.tri_data.clone().requires_grad_(True))
    from_pieces = accel.intersect_scene(leaf, medium, o, d, torch.inf)
    for f in dataclasses.fields(hit):
        got = getattr(hit, f.name).detach()
        assert got.dtype == getattr(ref, f.name).dtype, f.name
        assert torch.equal(got, getattr(ref, f.name).detach()), f.name
        assert torch.equal(getattr(from_query, f.name), getattr(from_pieces, f.name).detach()), f.name
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=1e-6, atol=1e-9)


class _Shapes(TorchDispatchMode):
    """The shapes of every tensor that an aten operation returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.seen.append((func.overloadpacket.__name__, tuple(t.shape)))
        return out


def _nodes(fn):
    """Every node of an autograd graph from ``fn``."""
    seen, stack = set(), [fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(next_fn for next_fn, _ in node.next_functions)
    return seen


def test_reconstruction_slices_no_gathered_rows(pack):
    """On a graph-carrying ``tri_data`` (and ``inst_data``) the hit's
    graph holds one gather node a table and no ``SliceBackward0`` over a
    gather's output, and neither its forward nor its backward builds a
    tensor of (N, 32): the backward takes the pieces' gradients alone."""
    medium, o, d = _rays(N_LANES, 14)
    moved, shift = _moved(pack)
    with _Shapes() as forward:
        hit = accel.intersect_scene(moved, medium, o, d, torch.inf)
    loss = _hit_loss(hit)
    nodes = _nodes(loss.grad_fn)
    gathers = {n for n in nodes if type(n).__name__ == "_GatherRowsBackward"}
    assert len(gathers) == 2
    slices = [n for n in nodes if type(n).__name__ == "SliceBackward0"]
    assert not [n for n in slices if any(f in gathers for f, _ in n.next_functions)]
    with _Shapes() as backward:
        loss.backward()
    assert shift.grad is not None and shift.grad.abs().sum() > 0
    for label, mode in (("forward", forward), ("backward", backward)):
        wide = [(name, shape) for name, shape in mode.seen if shape == (N_LANES, 32)]
        assert not wide, (label, wide)
    # the composition it replaces builds them: one (N, 32) gather a table, and in the backward a zero
    # (N, 32) tensor a piece
    rows = pack.tri_data.clone().requires_grad_(True)
    sliced = _sliced_rows(rows, torch.zeros(N_LANES, dtype=torch.int32), TRI_COLUMNS)
    with _Shapes() as old:
        sum(p.sum() for p in sliced[:-1]).backward()
    assert sum(shape == (N_LANES, 32) for _, shape in old.seen) >= 9


def test_geometry_step_backward_builds_no_row_wide_tensors():
    """A whole geometry step's backward (``backward_ops.count``: the
    detector moved by ``translate_instance``, 1,000 lanes, path length 2)
    slices, fills and adds nothing of (N, 32), where the (N, 32) gathers
    sliced into pieces made a zero row, a copy and an add of that width a
    piece; the (N, 3) pieces' accumulations stay."""
    counts = count(1000, 2)
    wide = {(op, shape): n for (op, shape), n in counts.items() if shape[-1:] == (32,) and shape[:1] == ("N",)}
    assert not wide, wide
    assert counts["aten::add_", ("N", 3)] > 0
