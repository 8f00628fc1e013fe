"""The table read: linear interpolation in lookup tables, forward and
backward, on the kernels of ``csrc/table_read.cu``.

Three forms, each the read of a ``theia_tpu`` function, op for op:

* :func:`read_table` - one table of ``n`` equidistant samples over
  [0, 1], ``v_lo * (1 - l) + v_hi * l`` (``theia_tpu.lookup.lookup``;
  every single-medium read: the volume and photon tracers, the phase
  tables, polarization);
* :func:`read_packed` - a medium's row of packed (M, L) tables,
  ``v_j + l * (v_{j+1} - v_j)`` with the slope of the last column 0, and
  ``null_value`` where the table is null (size 0)
  (``theia_tpu.material.lookup_packed``; the scene tracer's IOR and
  phase reads), or of C such tables stacked (M, L, C) and read at once
  (the four constants tables, the ``const4`` read of
  ``theia_tpu.material.packed_medium_constants``, which stacks them as
  value/slope rows: the kernel takes the same slope, ``v_{j+1} - v_j``,
  in the same float32 op);
* :func:`gather_rows` - whole rows of a table, ``table[index]``, the
  ``tri_data`` and ``inst_data`` rows that ``accel._reconstruct_hit``
  rebuilds a hit from (``jnp.take`` in ``theia_tpu.accel``).

Each is differentiable in the table and (the first two) in the
coordinate. The clip of
the coordinate to [0, 1] takes ``jnp.clip``'s gradient: 1 inside, 0
outside, and 1/2 on the bounds themselves, where JAX's max/min split a
tie (torch's ``clamp`` would pass 1).

On CPU tensors the plain versions run (``*_plain``; the backward's plain
versions write the gradient out, as the kernels do); on CUDA tensors the
kernels run, or the call raises. The forward kernels are bit-equal to
their plain versions (the same float32 ops in the same order, built with
``-fmad=false``): one ulp of an index of refraction, a coefficient or a
group velocity could flip a Fresnel or scatter decision. The backward
kernels add each lane's share of the table's gradient into a copy of the
whole table in a block's shared memory, then into the output with one
atomic a nonzero entry (straight into device memory above
:data:`SHARED_TABLE_MAX` floats), so the table's gradient agrees with the
plain version's sequential sums to float32 rounding only; the
coordinate's gradient is written a lane, without atomics, and is
bit-equal.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = [
    "clip01",
    "read_table",
    "read_table_plain",
    "read_table_grad",
    "read_table_grad_plain",
    "read_packed",
    "read_packed_plain",
    "read_packed_grad",
    "read_packed_grad_plain",
    "gather_rows",
    "gather_rows_grad",
    "MAX_CHANNELS",
    "SHARED_TABLE_MAX",
]

#: the largest table (floats) whose gradient a block sums in shared
#: memory: 226 KB of floats; equals kSharedMaxFloats of ``csrc/table_read.cu``
SHARED_TABLE_MAX = 57_856


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1] with ``jnp.clip``'s gradient (1/2 at a
    bound); a NaN stays NaN."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip01 / dx: 1 inside (0, 1), 1/2 on a bound, 0 outside."""
    inside = ((x > 0.0) & (x < 1.0)).to(x.dtype)
    return torch.where((x == 0.0) | (x == 1.0), 0.5, inside)


def _index(f: torch.Tensor, n: int) -> torch.Tensor:
    """int64 row of a float index, clamped into [0, n - 1]."""
    return torch.clamp(f.to(torch.int64), 0, n - 1)


def _launch(fn, name: str, *args) -> None:
    _build.check(getattr(_build.library(), name)(*args), name)
    fn.launches += 1


def _stream(t: torch.Tensor) -> int:
    return _build.stream_handle(t.device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _on_card(*tensors) -> bool:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"table read: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"table read: every tensor must be on {dev}, got {t.device}")
    return dev.type == "cuda"


def _check(name: str, a: torch.Tensor, dtype, ndim: int) -> None:
    if a.dtype != dtype or a.dim() != ndim or not a.is_contiguous():
        raise ValueError(f"table read: {name} must be a contiguous {ndim}-d {dtype} tensor")


def _differentiable(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# one table: theia_tpu.lookup.lookup
# ---------------------------------------------------------------------------


def _single_coords(n: int, u: torch.Tensor):
    x = clip01(u) * float(n - 1)
    fl = torch.floor(x)
    return x, fl, x - fl


def read_table_plain(table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`read_table`'s forward (any device)."""
    n = table.shape[0]
    x, fl, l = _single_coords(n, u)
    v_lo = table[_index(fl, n)]
    v_hi = table[_index(torch.ceil(x), n)]
    return v_lo * (1.0 - l) + v_hi * l


def read_table_grad_plain(table, u, grad_out, need_table: bool = True, need_u: bool = True):
    """Plain version of :func:`read_table_grad`: (d table, d u), either
    None where not asked for."""
    n = table.shape[0]
    x, fl, l = _single_coords(n, u)
    lo, hi = _index(fl, n), _index(torch.ceil(x), n)
    grad_table = grad_u = None
    if need_table:
        grad_table = torch.zeros_like(table)
        grad_table.index_add_(0, lo, grad_out * (1.0 - l))
        grad_table.index_add_(0, hi, grad_out * l)
    if need_u:
        grad_u = (grad_out * table[hi] - grad_out * table[lo]) * float(n - 1) * _clip_grad(u)
    return grad_table, grad_u


def _read_table_forward(table, u):
    if not _on_card(table, u):
        return read_table_plain(table, u)
    out = torch.empty_like(u)
    if u.numel():
        _launch(read_table, "theia_table_read", table.data_ptr(), table.shape[0], u.data_ptr(),
                u.numel(), out.data_ptr(), _stream(u))
    return out


def read_table_grad(table, u, grad_out, need_table: bool = True, need_u: bool = True):
    """Backward of :func:`read_table`: (d table, d u) for the upstream
    gradient ``grad_out``, either None where not asked for. CUDA tensors
    launch ``theia_table_read_grad``, CPU tensors run the plain version."""
    if not _on_card(table, u, grad_out):
        return read_table_grad_plain(table, u, grad_out, need_table, need_u)
    grad_table = torch.zeros_like(table) if need_table else None
    grad_u = torch.empty_like(u) if need_u else None
    if u.numel() and (need_table or need_u):
        _launch(read_table_grad, "theia_table_read_grad", table.data_ptr(), table.shape[0],
                u.data_ptr(), grad_out.data_ptr(), u.numel(), _ptr(grad_table), _ptr(grad_u),
                _stream(u))
    elif need_u:
        grad_u.zero_()
    return grad_table, grad_u


class _TableRead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, u):
        ctx.save_for_backward(table, u)
        return _read_table_forward(table, u)

    @staticmethod
    def backward(ctx, grad_out):
        table, u = ctx.saved_tensors
        return read_table_grad(table, u, grad_out.contiguous(), *ctx.needs_input_grad)


def read_table(table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``table`` (f32 (n,), n >= 1) interpolated at ``u`` (f32, any shape)
    clipped to [0, 1]: ``v_lo * (1 - l) + v_hi * l`` with ``x = u * (n -
    1)``, ``v_lo = table[floor(x)]``, ``v_hi = table[ceil(x)]``, ``l = x -
    floor(x)``. Differentiable in both; saves nothing where no gradient
    is asked for."""
    _check("table", table, torch.float32, 1)
    if table.shape[0] < 1:
        raise ValueError("read_table: an empty table is a null table; read it as None")
    flat = u.reshape(-1).contiguous()
    _check("u", flat, torch.float32, 1)
    if _differentiable(table, flat):
        out = _TableRead.apply(table, flat)
    else:
        out = _read_table_forward(table, flat)
    return out.reshape(u.shape)


read_table.launches = 0
read_table_grad.launches = 0


# ---------------------------------------------------------------------------
# packed tables: theia_tpu.material.lookup_packed and the const4 read
# ---------------------------------------------------------------------------

#: the most channels a packed read takes (the const4 read's four)
MAX_CHANNELS = 4


def _channels(values: torch.Tensor) -> int:
    return values.shape[2] if values.dim() == 3 else 1


def _packed_coords(values, sizes, handle, t):
    length = values.shape[1]
    n = sizes[handle]
    tt = clip01(t) * torch.clamp_min(n - 1, 1).to(torch.float32)
    fl = torch.floor(tt)
    j = _index(fl, length)
    flat = handle.to(torch.int64) * length + j
    return n, j, flat, tt - fl, length


def _packed_slope(rows, j, flat, length):
    """(v_j, v_{j+1} - v_j) of each lane's row of ``rows`` (M * L, C), the
    slope 0 in the last column."""
    v = rows[flat]
    v1 = rows[torch.clamp_max(flat + 1, rows.shape[0] - 1)]
    return v, torch.where((j < length - 1)[:, None], v1 - v, 0.0)


def _nulls(null_value, channels: int) -> tuple[float, ...]:
    nulls = (null_value,) * channels if isinstance(null_value, (int, float)) else tuple(null_value)
    if len(nulls) != channels:
        raise ValueError(f"read_packed: {channels} channels take {channels} null values, got {len(nulls)}")
    return tuple(float(v) for v in nulls)


def read_packed_plain(values, sizes, handle, t, null_value=0.0) -> torch.Tensor:
    """Plain version of :func:`read_packed`'s forward (any device; flat
    ``handle`` and ``t``)."""
    c = _channels(values)
    n, j, flat, l, length = _packed_coords(values, sizes, handle, t)
    v, dv = _packed_slope(values.reshape(-1, c), j, flat, length)
    nulls = torch.tensor(_nulls(null_value, c), dtype=torch.float32, device=t.device)
    res = torch.where((n == 0)[:, None], nulls, v + l[:, None] * dv)
    return res if values.dim() == 3 else res[:, 0]


def read_packed_grad_plain(values, sizes, handle, t, grad_out, need_values=True, need_t=True):
    """Plain version of :func:`read_packed_grad`."""
    c = _channels(values)
    rows = values.reshape(-1, c)
    n, j, flat, l, length = _packed_coords(values, sizes, handle, t)
    g = torch.where((n == 0)[:, None], 0.0, grad_out.reshape(-1, c))
    l = l[:, None]
    grad_values = grad_t = None
    if need_values:
        last = (j == length - 1)[:, None]
        grad = torch.zeros_like(rows)
        grad.index_add_(0, flat, torch.where(last, g, g - g * l))
        grad.index_add_(0, torch.clamp_max(flat + 1, rows.shape[0] - 1), torch.where(last, 0.0, g * l))
        grad_values = grad.reshape(values.shape)
    if need_t:
        _, dv = _packed_slope(rows, j, flat, length)
        prod = g * dv
        dt = prod[:, 0]
        for k in range(1, c):  # the kernel's order
            dt = dt + prod[:, k]
        grad_t = dt * torch.clamp_min(n - 1, 1).to(torch.float32) * _clip_grad(t)
    return grad_values, grad_t


def _read_packed_forward(values, sizes, handle, t, nulls):
    if not _on_card(values, sizes, handle, t):
        return read_packed_plain(values, sizes, handle, t, nulls)
    c = _channels(values)
    out = torch.empty((t.shape[0], c) if values.dim() == 3 else t.shape, dtype=torch.float32, device=t.device)
    if t.numel():
        _launch(read_packed, "theia_packed_read", values.data_ptr(), values.shape[0], values.shape[1], c,
                sizes.data_ptr(), handle.data_ptr(), t.data_ptr(),
                *(ctypes.c_float(v) for v in nulls + (0.0,) * (MAX_CHANNELS - c)), t.numel(),
                out.data_ptr(), _stream(t))
    return out


def read_packed_grad(values, sizes, handle, t, grad_out, need_values=True, need_t=True):
    """Backward of :func:`read_packed`: (d values, d t), either None where
    not asked for; null lanes give exact zeros. CUDA tensors launch
    ``theia_packed_read_grad``, CPU tensors run the plain version."""
    if not _on_card(values, sizes, handle, t, grad_out):
        return read_packed_grad_plain(values, sizes, handle, t, grad_out, need_values, need_t)
    grad_values = torch.zeros_like(values) if need_values else None
    grad_t = torch.empty_like(t) if need_t else None
    if t.numel() and (need_values or need_t):
        _launch(read_packed_grad, "theia_packed_read_grad", values.data_ptr(), values.shape[0],
                values.shape[1], _channels(values), sizes.data_ptr(), handle.data_ptr(), t.data_ptr(),
                grad_out.data_ptr(), t.numel(), _ptr(grad_values), _ptr(grad_t), _stream(t))
    elif need_t:
        grad_t.zero_()
    return grad_values, grad_t


class _PackedRead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, sizes, handle, t, nulls):
        ctx.save_for_backward(values, sizes, handle, t)
        return _read_packed_forward(values, sizes, handle, t, nulls)

    @staticmethod
    def backward(ctx, grad_out):
        values, sizes, handle, t = ctx.saved_tensors
        need = ctx.needs_input_grad
        gv, gt = read_packed_grad(values, sizes, handle, t, grad_out.contiguous(), need[0], need[3])
        return gv, None, None, gt, None


def read_packed(values, sizes, handle, t, null_value=0.0) -> torch.Tensor:
    """Per-lane read of packed tables: ``values`` f32 (M, L), or (M, L, C)
    for C <= :data:`MAX_CHANNELS` tables read at once, ``sizes`` i32 (M,),
    ``handle`` integer (any shape), ``t`` f32 (``handle``'s shape)
    clipped to [0, 1]. Row ``j = floor(t * max(n - 1, 1))`` of the lane's
    medium gives ``v_j + l * (v_{j+1} - v_j)`` in each channel (slope 0
    in the last column, so a table shorter than L reads its padding
    there); lanes whose table is null (n = 0) give ``null_value`` (a
    float, or C floats). Returns ``t``'s shape, with a last axis of C
    for a 3-d ``values``; differentiable in ``values`` and ``t``."""
    if values.dim() not in (2, 3) or (values.dim() == 3 and not 1 <= values.shape[2] <= MAX_CHANNELS):
        raise ValueError(f"read_packed: values must be (M, L) or (M, L, C) with C <= {MAX_CHANNELS}")
    _check("values", values, torch.float32, values.dim())
    _check("sizes", sizes, torch.int32, 1)
    shape = t.shape
    t = t.reshape(-1).contiguous()
    handle = handle.reshape(-1).to(torch.int32).contiguous()
    _check("t", t, torch.float32, 1)
    if handle.shape != t.shape:
        raise ValueError("read_packed: handle and t must have the same shape")
    nulls = _nulls(null_value, _channels(values))
    if _differentiable(values, t):
        out = _PackedRead.apply(values, sizes, handle, t, nulls)
    else:
        out = _read_packed_forward(values, sizes, handle, t, nulls)
    return out.reshape(shape + out.shape[1:])


read_packed.launches = 0
read_packed_grad.launches = 0


# ---------------------------------------------------------------------------
# whole rows: the hit reconstruction's tri_data and inst_data rows
# ---------------------------------------------------------------------------


def _gather_forward(table, index):
    if not _on_card(table, index):
        return table[index]
    out = torch.empty((index.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if index.numel():
        _launch(gather_rows, "theia_gather_rows", table.data_ptr(), table.shape[1], index.data_ptr(),
                index.shape[0], out.data_ptr(), _stream(table))
    return out


def gather_rows_grad(n_rows: int, index, grad_out):
    """Backward of :func:`gather_rows`: d table (``n_rows`` rows as wide
    as ``grad_out``), each row the sum of the gradients of the lanes that
    read it. CUDA tensors launch ``theia_gather_rows_grad`` (atomics, in
    a block's shared copy of the table where it fits), CPU tensors run
    ``index_add_``."""
    grad = torch.zeros((n_rows, grad_out.shape[1]), dtype=grad_out.dtype, device=grad_out.device)
    if not _on_card(grad_out, index):
        return grad.index_add_(0, index.to(torch.int64), grad_out)
    if index.numel():
        _launch(gather_rows_grad, "theia_gather_rows_grad", grad_out.data_ptr(), grad_out.shape[1],
                index.data_ptr(), index.shape[0], n_rows, grad.data_ptr(), _stream(grad_out))
    return grad


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.n_rows = table.shape[0]
        return _gather_forward(table, index)

    @staticmethod
    def backward(ctx, grad_out):
        (index,) = ctx.saved_tensors
        return gather_rows_grad(ctx.n_rows, index, grad_out.contiguous()), None


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for an f32 (T, W) table and row indices (N,) in
    [0, T): the (N, W) rows, differentiable in the table (a row's
    gradient sums the lanes that read it). The scene tables' rows that
    ``accel._reconstruct_hit`` rebuilds a hit from: where ``tri_data`` or
    ``inst_data`` carries a graph (an instance moved by
    ``translate_instance``) torch's index backward sorted 262,144 lanes
    for each of them, and the card's gather kernel copies bit for bit."""
    _check("table", table, torch.float32, 2)
    index = index.to(torch.int32).contiguous()
    if index.dim() != 1:
        raise ValueError("gather_rows: index must be 1-d")
    if _differentiable(table):
        return _GatherRows.apply(table, index)
    return _gather_forward(table, index)


gather_rows.launches = 0
gather_rows_grad.launches = 0
