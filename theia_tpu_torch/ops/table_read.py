"""The table read: linear interpolation in lookup tables, forward and
backward, on the kernels of ``csrc/table_read.cu``.

Three forms, each the read of a ``theia_tpu`` function, op for op:

* :func:`read_table` - up to four single tables, each of its own ``n``
  equidistant samples over [0, 1] (``None`` reads its null value), read
  at one coordinate: ``v_lo * (1 - l) + v_hi * l``
  (``theia_tpu.lookup.lookup``; every single-medium read: the volume and
  photon tracers, the phase tables, ``medium_constants``' four,
  ``phase_matrix_elements``' four);
* :func:`read_packed` - up to four packed (M, L_k) tables of one store,
  read at each lane's medium row ``handle`` and coordinate: ``v_j + l *
  (v_{j+1} - v_j)`` with the slope of the last column 0, and the table's
  null value where it is null (size 0)
  (``theia_tpu.material.lookup_packed``; the scene tracer's IOR, phase and
  phase-matrix reads); with ``shared=True`` the four constants tables as
  the ``const4`` read of ``theia_tpu.material.packed_medium_constants``
  stacks them (one size for all, the largest; a null table its null value
  across its own width, 0 in the padding beyond), read from the kinds' own
  tables without stacking;
* :func:`gather_rows` - whole rows of a table, ``table[index]``, or with
  ``columns=`` the spans of them that a caller reads, one output a span
  (integer columns converted): the pieces of the ``tri_data`` and
  ``inst_data`` rows that ``accel._reconstruct_hit`` rebuilds a hit from
  (``jnp.take`` and the slices of it in ``theia_tpu.accel``); its
  backward takes the spans' gradients alone.

The coordinate of the first two is formed from each lane's input ``x``
in the kernel, as the JAX composition at the call site forms it: ``x``
itself; ``affine=(a, b)``, ``a * x + b`` (the phase reads' ``0.5 *
(cos_theta + 1)`` as :data:`PHASE`: halving is exact, so ``0.5 * x +
0.5`` rounds the same); or ``bounds=(lambda_min, lambda_max)``, the
wavelength's ``(x - lambda_min) / (lambda_max - lambda_min)`` with a
medium's bounds read by handle (packed) or the one medium's (single).
``clips`` counts the clips to [0, 1] that the composition applies: 1 (the
read's own), or 2 where the caller clips before a read that clips again
(``_fresnel``'s IOR, ``medium_constants``). Each is differentiable in the
tables and in ``x``; the bounds are data and take no gradient. A clip
takes ``jnp.clip``'s gradient: 1 inside, 0 outside, and 1/2 on the bounds
themselves, where JAX's max/min split a tie (torch's ``clamp`` would pass
1), so 1/4 where two clips meet a bound.

On CPU tensors the plain versions run (``*_plain``; the backward's plain
versions write the gradient out, as the kernels do); on CUDA tensors the
kernels run, or the call raises. The forward kernel is bit-equal to its
plain version (the same float32 ops in the same order, built with
``-fmad=false``): one ulp of an index of refraction, a coefficient or a
group velocity could flip a Fresnel or scatter decision. The backward
kernels add no float with an atomic: a table entry's gradient is its
lanes' shares summed in the records' fixed order (``ops/ordered.py``:
spans of 128 lanes, tiles of 1024, 32 groups of tiles), which the plain
versions repeat, so the tables' gradients too are bit-equal to the plain
versions' and the same on every launch; the input's gradient is written a
lane.

A call checks its tables once a table set: the first call with a set of
tensors validates them and builds the kernel's constants (pointers,
widths, nulls, the form), kept while those tensor objects live and hold
their storage. Nothing derived from the tables' values is kept, so a table
edited in place is read as it is at each launch, and a table or store
replaced by another tensor takes a new entry. A call then checks only the
lanes (``x``, ``handle``), allocates the output and launches on torch's
current stream: no host read of a device value, so a CUDA graph can
capture it.
"""

from __future__ import annotations

import ctypes
import weakref
from functools import lru_cache, reduce

import torch

from .. import _build
from .ordered import TILE_LANES, ordered_bin_sums, record_counters, record_table, slot_sums

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
    "packed_spec",
    "gather_rows",
    "gather_rows_plain",
    "gather_rows_grad",
    "gather_rows_grad_plain",
    "MAX_SPANS",
    "MAX_TABLES",
    "PHASE",
]

#: the most tables one read takes; equals kMaxTables of ``csrc/table_read.cu``
MAX_TABLES = 4
#: the coordinate's forms; equal kT, kAffine, kWavelength of ``csrc/table_read.cu``
T, AFFINE, WAVELENGTH = 0, 1, 2
#: the phase reads' coordinate 0.5 * (cos_theta + 1) as a * x + b
PHASE = (0.5, 0.5)


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
# a table set, validated once: theia_tpu.lookup.lookup, lookup_packed and
# the const4 read
# ---------------------------------------------------------------------------


class _Spec(ctypes.Structure):
    """The kernel's constants: Spec of ``csrc/table_read.cu``, field for field."""

    _fields_ = [
        ("values", ctypes.c_void_p * MAX_TABLES),
        ("sizes", ctypes.c_void_p * MAX_TABLES),
        ("lambda_min", ctypes.c_void_p),
        ("lambda_max", ctypes.c_void_p),
        ("len", ctypes.c_int * MAX_TABLES),
        ("nulls", ctypes.c_float * MAX_TABLES),
        ("tables", ctypes.c_int),
        ("packed", ctypes.c_int),
        ("shared", ctypes.c_int),
        ("form", ctypes.c_int),
        ("clips", ctypes.c_int),
        ("media", ctypes.c_int),
        ("a", ctypes.c_float),
        ("b", ctypes.c_float),
    ]


class _Reader:
    """One table set's read, validated: the tables' widths (``lens``:
    packed, a row's width; single, the samples, 0 for ``None``), their
    nulls, the form, and the kernel's :class:`_Spec` (its address in
    ``spec_address``). ``bounds`` holds float32 tensors made from bounds
    given as floats (else None: the call's tensors are read)."""

    def __init__(self, packed, tables, sizes, nulls, affine, bounds, clips, shared, device):
        if not 1 <= len(tables) <= MAX_TABLES:
            raise ValueError(f"table read: 1 to {MAX_TABLES} tables, got {len(tables)}")
        nulls = (nulls,) * len(tables) if isinstance(nulls, (int, float)) else tuple(nulls)
        if len(nulls) != len(tables):
            raise ValueError(f"table read: {len(tables)} tables take {len(tables)} null values, got {len(nulls)}")
        if clips not in (1, 2) or (affine is not None and bounds is not None) or (shared and not packed):
            raise ValueError("table read: clips is 1 or 2, affine and bounds exclude each other, shared is packed")
        self.packed, self.shared, self.clips = packed, shared, clips
        self.nulls = tuple(float(v) for v in nulls)
        self.form = AFFINE if affine is not None else (WAVELENGTH if bounds is not None else T)
        self.a, self.b = (float(affine[0]), float(affine[1])) if affine is not None else (1.0, 0.0)
        self.device, self.media = device, 1
        if packed:
            if len(sizes) != len(tables):
                raise ValueError("read_packed: a sizes tensor for each table")
            self.media = tables[0].shape[0] if tables[0].dim() == 2 else -1
            for v, s in zip(tables, sizes):
                _check("values", v, torch.float32, 2)
                _check("sizes", s, torch.int32, 1)
                if v.shape[0] != self.media or s.shape[0] != self.media or v.shape[1] < 1:
                    raise ValueError("read_packed: every table (M, L >= 1) and sizes (M,) of one store")
            self.lens = tuple(v.shape[1] for v in tables)
        else:
            for v in tables:
                if v is not None:
                    _check("table", v, torch.float32, 1)
                    if v.shape[0] < 1:
                        raise ValueError("read_table: an empty table is a null table; read it as None")
            self.lens = tuple(0 if v is None else v.shape[0] for v in tables)
        self.bounds = None
        if bounds is not None:
            lo, hi = (b if isinstance(b, torch.Tensor) else torch.tensor(float(b), dtype=torch.float32, device=device)
                      for b in bounds)
            if not all(isinstance(b, torch.Tensor) for b in bounds):
                self.bounds = (lo, hi)
            for b in (lo, hi):
                if b.dtype != torch.float32 or not b.is_contiguous() or b.numel() != (self.media if packed else 1):
                    raise ValueError("table read: bounds are float32, one a medium (packed) or one (single)")
        for t in (*tables, *(sizes or ()), *(() if bounds is None else (lo, hi))):
            if t is not None and t.device != device:
                raise ValueError(f"table read: every tensor must be on {device}, got {t.device}")
        pad = lambda xs, fill: tuple(xs) + (fill,) * (MAX_TABLES - len(xs))
        self.spec = _Spec(
            (ctypes.c_void_p * MAX_TABLES)(*pad([_ptr(v) for v in tables], None)),
            (ctypes.c_void_p * MAX_TABLES)(*pad([_ptr(s) for s in sizes or ()], None)),
            None if bounds is None else lo.data_ptr(), None if bounds is None else hi.data_ptr(),
            (ctypes.c_int * MAX_TABLES)(*pad(self.lens, 0)),
            (ctypes.c_float * MAX_TABLES)(*pad(self.nulls, 0.0)),
            len(tables), int(packed), int(shared), self.form, clips, self.media, self.a, self.b,
        )
        self.spec_address = ctypes.addressof(self.spec)

    # -- the plain versions: the composition each form replaces, op for op --

    def coordinate(self, bounds, handle, x):
        """(r, span): the coordinate as formed from ``x`` before any clip,
        and the wavelength range that divided it."""
        if self.form == AFFINE:
            return x * self.a + self.b, None
        if self.form == WAVELENGTH:
            lo, hi = self.bounds or bounds
            if self.packed:
                lo, hi = lo[handle], hi[handle]
            else:
                lo, hi = lo.reshape(()), hi.reshape(())
            span = hi - lo
            return (x - lo) / span, span
        return x, None

    def cells(self, sizes, handle, t):
        """Each table's (n, pad, scale, j, l, n_k) at the lanes: the const4
        rule's shared n and width, or the table's own."""
        nk = [s[handle] for s in sizes]
        if not self.shared:
            return [self._cell(n, length, t) + (n,) for n, length in zip(nk, self.lens)]
        cell = self._cell(reduce(torch.maximum, nk), max(self.lens), t)
        return [cell + (n,) for n in nk]

    @staticmethod
    def _cell(n, pad, t):
        scale = torch.clamp_min(n - 1, 1).to(torch.float32)
        tt = t * scale
        fl = torch.floor(tt)
        return n, pad, scale, _index(fl, pad), tt - fl

    def column(self, k, values, handle, nk, c):
        """Column ``c`` of table k's rows as the const4 rule reads it."""
        length = self.lens[k]
        v = values.reshape(-1)[handle * length + torch.clamp_max(c, length - 1)]
        v = torch.where(nk == 0, self.nulls[k], v)
        return torch.where(c < length, v, 0.0)

    def plain(self, tables, sizes, bounds, handle, x) -> list:
        """The K tables' values at the lanes."""
        r, _ = self.coordinate(bounds, handle, x)
        t = clip01(r)
        if self.clips == 2:
            t = clip01(t)
        out = []
        if not self.packed:
            for table, null in zip(tables, self.nulls):
                if table is None:
                    out.append(torch.full_like(x, null))
                    continue
                n = table.shape[0]
                xx = t * float(n - 1)
                fl = torch.floor(xx)
                l = xx - fl
                out.append(table[_index(fl, n)] * (1.0 - l) + table[_index(torch.ceil(xx), n)] * l)
            return out
        h = handle.to(torch.int64)
        for k, (n, pad, _, j, l, nk) in enumerate(self.cells(sizes, h, t)):
            v = self.column(k, tables[k], h, nk, j)
            slope = torch.where(j < pad - 1, self.column(k, tables[k], h, nk, j + 1) - v, 0.0)
            out.append(torch.where(n == 0, self.nulls[k], v + l * slope))
        return out

    def grad_sizes(self, need_tables) -> list:
        """The floats of each table's gradient, 0 where it takes none: the
        tables that take one lie end to end in one buffer, in order."""
        media = self.media if self.packed else 1
        return [media * length if need else 0 for need, length in zip(need_tables, self.lens)]

    def grad_plain(self, tables, sizes, bounds, handle, x, grad_out, need_tables, need_x):
        """(d tables, d x) for the upstream gradient ``grad_out`` (one row a
        table, None for a zero one), None where not asked for; the kernel's
        float32 ops in its order. Each table entry's sum over the lanes is
        the kernel's: a lane's two shares of each table (slots 2 k and 2 k +
        1), the tables that take a gradient laid end to end, summed in the
        records' fixed order (:func:`.ordered.slot_sums`)."""
        grad_out = [torch.zeros_like(x) if g is None else g for g in grad_out]
        need_tables = [bool(need) and t is not None for need, t in zip(need_tables, tables)]
        lengths = self.grad_sizes(need_tables)
        offsets = [sum(lengths[:k]) for k in range(len(tables))]
        r, span = self.coordinate(bounds, handle, x)
        t = clip01(r)
        cg = _clip_grad(clip01(r) if self.clips == 2 else r)
        du = torch.zeros_like(x)
        # the slots of tables that take no gradient hold no item: left out,
        # they change no other slot's place in the order
        slots = []
        if not self.packed:
            for k, table in enumerate(tables):
                if table is None:
                    continue
                n, g = table.shape[0], grad_out[k]
                xx = t * float(n - 1)
                fl = torch.floor(xx)
                l = xx - fl
                lo, hi = _index(fl, n), _index(torch.ceil(xx), n)
                if need_tables[k]:
                    every = torch.ones_like(x, dtype=torch.bool)
                    slots += [(offsets[k] + lo, g * (1.0 - l), every), (offsets[k] + hi, g * l, every)]
                du = du + (g * table[hi] - g * table[lo]) * float(n - 1) * cg
        else:
            h = handle.to(torch.int64)
            cells = self.cells(sizes, h, t)
            for k, (n, pad, scale, j, l, nk) in enumerate(cells):
                length = self.lens[k]
                g = torch.where(n == 0, 0.0, grad_out[k])
                last = j == pad - 1
                if need_tables[k]:
                    real = (n != 0) & (nk != 0)
                    base = offsets[k] + h * length
                    slots += [(base + j, torch.where(last, g, g - g * l), real & (j < length)),
                              (base + j + 1, g * l, real & ~last & (j + 1 < length))]
                v = self.column(k, tables[k], h, nk, j)
                slope = torch.where(j < pad - 1, self.column(k, tables[k], h, nk, j + 1) - v, 0.0)
                du = du + g * slope if self.shared else du + g * slope * scale * cg
            if self.shared:
                du = du * cells[0][2] * cg
        grads = [None] * len(tables)
        if any(need_tables):
            flat = slot_sums(slots, x.shape[0], sum(lengths))
            for k, table in enumerate(tables):
                if need_tables[k]:
                    grads[k] = flat[offsets[k]:offsets[k] + lengths[k]].reshape(table.shape)
        if not need_x:
            return grads, None
        if self.clips == 2:
            du = du * _clip_grad(r)
        if self.form == AFFINE:
            du = du * self.a
        elif self.form == WAVELENGTH:
            du = du / span
        return grads, du


#: table sets already validated: key (the form and the tensors' ids) ->
#: (the tensors' data pointers, _Reader, weak references whose callbacks
#: drop the entry when a tensor of the set is freed, so that an id found
#: here is still that tensor's); cleared when it outgrows _MAX_READERS
_READERS: dict = {}
_MAX_READERS = 256


_data_ptr = torch.Tensor.data_ptr


def _reader(packed, tables, sizes, nulls, affine, bounds, clips, shared, device) -> _Reader:
    """The :class:`_Reader` of this table set: found by the form and the
    tensors' identities (live, since a freed tensor's entry is dropped)
    and checked to hold the same storage, else validated and built."""
    if isinstance(nulls, list):
        nulls = tuple(nulls)
    tensors = [*tables, *(sizes or ())] if packed else [t for t in tables if t is not None]
    bound_key = None
    if bounds is not None:
        bound_key = tuple(id(b) if isinstance(b, torch.Tensor) else float(b) for b in bounds)
        tensors += [b for b in bounds if isinstance(b, torch.Tensor)]
    key = (packed, nulls, affine, clips, shared, device, bound_key, *map(id, tables), *map(id, sizes or ()))
    pointers = tuple(map(_data_ptr, tensors))
    hit = _READERS.get(key)
    if hit is not None and hit[0] == pointers:
        return hit[1]
    reader = _Reader(packed, tables, sizes, nulls, affine, bounds, clips, shared, device)
    if len(_READERS) >= _MAX_READERS:
        _READERS.clear()
    drop = lambda _, key=key: _READERS.pop(key, None)
    _READERS[key] = (pointers, reader, [weakref.ref(t, drop) for t in tensors])
    return reader


def _forward(reader: _Reader, tables, sizes, bounds, handle, x, separate: bool = False) -> tuple:
    """The K tables' values at the lanes: the plain version on the CPU, a
    launch on the card into one (K, N) buffer, or into K tensors of their
    own with ``separate`` (the outputs of the autograd function)."""
    if x.device.type != "cuda":
        return tuple(reader.plain(tables, sizes, bounds, handle, x))
    n, k = x.shape[0], len(tables)
    if separate or k == 1:
        out = tuple(torch.empty(n, dtype=torch.float32, device=x.device) for _ in tables)
        rows = [o.data_ptr() for o in out]
    else:
        buffer = torch.empty((k, n), dtype=torch.float32, device=x.device)
        out = buffer.unbind(0)
        rows = [buffer.data_ptr() + 4 * n * j for j in range(k)]
    if n:
        _launch(read_packed if reader.packed else read_table, "theia_table_read", reader.spec_address,
                _ptr(handle), x.data_ptr(), x.stride(0), n, *rows, *[None] * (MAX_TABLES - k),
                _build.raw_stream(x))
    return out


def _backward(reader: _Reader, tables, sizes, bounds, handle, x, grad_out, need_tables, need_x):
    """(d tables, d x) for ``grad_out``, one row a table (None: zero)."""
    if x.device.type != "cuda":
        return reader.grad_plain(tables, sizes, bounds, handle, x, grad_out, need_tables, need_x)
    need_tables = [bool(need) and t is not None for need, t in zip(need_tables, tables)]
    lengths = reader.grad_sizes(need_tables)
    total, n = sum(lengths), x.shape[0]
    flat = torch.zeros(total, dtype=torch.float32, device=x.device)
    grads, at = [], 0
    for need, t, size in zip(need_tables, tables, lengths):
        grads.append(flat[at:at + size].view(t.shape) if need else None)
        at += size
    grad_x = torch.empty(x.shape, dtype=torch.float32, device=x.device) if need_x else None
    if n and (need_x or total):
        pad = [None] * (MAX_TABLES - len(tables))
        rows = [None if g is None else g.contiguous() for g in grad_out]
        table = record_table(n, total, x.device, 2 * len(tables)) if total else None
        _launch(read_packed_grad if reader.packed else read_table_grad, "theia_table_read_grad",
                reader.spec_address, _ptr(handle), x.data_ptr(), x.stride(0), *[_ptr(g) for g in rows + pad], n,
                sum(1 << k for k, need in enumerate(need_tables) if need), _ptr(flat) if total else None,
                _ptr(grad_x), _ptr(table), 0 if table is None else table.numel(),
                record_counters(flat).data_ptr() if total else None, _build.raw_stream(x))
    return grads, grad_x


class _Read(torch.autograd.Function):
    """The read as one autograd node: an output a table, those of tables
    that take no gradient (where ``x`` takes none either) marked
    non-differentiable, so that nothing downstream of them is tracked, and
    an output that no gradient reaches passes None, not zeros."""

    @staticmethod
    def forward(ctx, reader, sizes, bounds, handle, x, *tables):
        ctx.reader, ctx.sizes, ctx.bounds = reader, sizes, bounds
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(handle, x, *tables)
        out = _forward(reader, tables, sizes, bounds, handle, x, separate=True)
        need = ctx.needs_input_grad
        if not need[4]:
            ctx.mark_non_differentiable(*[o for o, n in zip(out, need[5:]) if not n])
        return out

    @staticmethod
    def backward(ctx, *grad_out):
        handle, x, *tables = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads, grad_x = _backward(ctx.reader, tables, ctx.sizes, ctx.bounds, handle, x, grad_out, need[5:], need[4])
        return (None, None, None, None, grad_x, *grads)


def _lanes(x: torch.Tensor, handle=None):
    """``x`` (and ``handle``) flat, checked: ``x`` may be a strided view
    (the kernels read it at its stride), ``handle`` is made contiguous."""
    if x.dtype != torch.float32:
        raise ValueError("table read: x must be float32")
    flat = x if x.dim() == 1 else x.reshape(-1)
    if handle is None:
        return flat, None
    if handle.device != x.device or handle.numel() != flat.shape[0]:
        raise ValueError("read_packed: handle and x must have the same shape and device")
    if handle.dtype != torch.int32:
        handle = handle.to(torch.int32)
    h = handle if handle.dim() == 1 else handle.reshape(-1)
    return flat, (h if h.is_contiguous() else h.contiguous())


def _read(reader, tables, sizes, bounds, handle, x, one: bool):
    shape = x.shape
    flat, handle = _lanes(x, handle)
    if torch.is_grad_enabled() and (flat.requires_grad or any(t is not None and t.requires_grad for t in tables)):
        if bounds is not None and any(isinstance(b, torch.Tensor) and b.requires_grad for b in bounds):
            raise ValueError("table read: the wavelength bounds take no gradient")
        out = _Read.apply(reader, sizes, bounds, handle, flat, *tables)
    else:
        out = _forward(reader, tables, sizes, bounds, handle, flat)
    if len(shape) != 1:
        out = tuple(o.view(shape) for o in out)
    return out[0] if one else tuple(out)


def _grad_rows(grad_out, one: bool, n: int) -> list:
    return [None if g is None else g.reshape(n) for g in ([grad_out] if one else grad_out)]


def _grads(grads, one: bool):
    return grads[0] if one else tuple(grads)


# ---------------------------------------------------------------------------
# single tables: theia_tpu.lookup.lookup
# ---------------------------------------------------------------------------


def _single(tables):
    one = isinstance(tables, torch.Tensor)
    return one, ((tables,) if one else tuple(tables))


def read_table(tables, x: torch.Tensor, null_value=0.0, *, affine=None, bounds=None, clips: int = 1):
    """Up to :data:`MAX_TABLES` tables (f32 (n_k,), n_k >= 1, or None for
    a null table, which reads its null value), each interpolated at the
    lanes' coordinate ``t``, clipped to [0, 1]: ``v_lo * (1 - l) + v_hi * l``
    with ``u = t * (n - 1)``, ``v_lo = table[floor(u)]``, ``v_hi =
    table[ceil(u)]``, ``l = u - floor(u)``. ``t`` is formed from ``x``
    (f32, any shape) as the module says: ``x``, ``affine`` or ``bounds``
    (the medium's two scalars, float32 tensors or floats), with ``clips``
    clips. ``null_value``: one float, or one a table. Returns ``x``'s
    shape for one table given as a tensor, else a tuple, one a table.
    Differentiable in the tables and ``x``; saves nothing where no
    gradient is asked for. One launch on the card."""
    one, tables = _single(tables)
    reader = _reader(False, tables, None, null_value, affine, bounds, clips, False, x.device)
    return _read(reader, tables, None, bounds, None, x, one)


def read_table_plain(tables, x, null_value=0.0, *, affine=None, bounds=None, clips: int = 1):
    """Plain version of :func:`read_table`'s forward (any device)."""
    one, tables = _single(tables)
    reader = _reader(False, tables, None, null_value, affine, bounds, clips, False, x.device)
    flat, _ = _lanes(x)
    out = reader.plain(tables, None, bounds, None, flat)
    return out[0].view(x.shape) if one else tuple(o.view(x.shape) for o in out)


def _table_grad(run, tables, x, grad_out, null_value, affine, bounds, clips, need_tables, need_x):
    one, tables = _single(tables)
    reader = _reader(False, tables, None, null_value, affine, bounds, clips, False, x.device)
    flat, _ = _lanes(x)
    need = [need_tables] * len(tables) if isinstance(need_tables, bool) else list(need_tables)
    grads, grad_x = run(reader, tables, None, bounds, None, flat, _grad_rows(grad_out, one, flat.shape[0]),
                        need, need_x)
    return _grads(grads, one), None if grad_x is None else grad_x.view(x.shape)


def read_table_grad(tables, x, grad_out, null_value=0.0, *, affine=None, bounds=None, clips: int = 1,
                    need_tables=True, need_x: bool = True):
    """Backward of :func:`read_table`: (d tables, d x) for the upstream
    gradient ``grad_out`` (as the forward returned: a tensor or a tuple),
    None where not asked for. CUDA tensors launch
    ``theia_table_read_grad``, CPU tensors run the plain version."""
    return _table_grad(_backward, tables, x, grad_out, null_value, affine, bounds, clips, need_tables, need_x)


def read_table_grad_plain(tables, x, grad_out, null_value=0.0, *, affine=None, bounds=None, clips: int = 1,
                          need_tables=True, need_x: bool = True):
    """Plain version of :func:`read_table_grad` (any device)."""
    return _table_grad(_Reader.grad_plain, tables, x, grad_out, null_value, affine, bounds, clips, need_tables,
                       need_x)


read_table.launches = 0
read_table_grad.launches = 0


# ---------------------------------------------------------------------------
# packed tables: theia_tpu.material.lookup_packed and the const4 read
# ---------------------------------------------------------------------------


def _packed(values, sizes):
    one = isinstance(values, torch.Tensor)
    return one, ((values,) if one else tuple(values)), ((sizes,) if isinstance(sizes, torch.Tensor) else tuple(sizes))


def read_packed(values, sizes, handle, x, null_value=0.0, *, affine=None, bounds=None, clips: int = 1,
                shared: bool = False):
    """Per-lane read of up to :data:`MAX_TABLES` packed tables of one
    store: ``values`` f32 (M, L_k) each, ``sizes`` i32 (M,) each (a tensor
    for a tensor, a tuple for a tuple), ``handle`` integer and ``x`` f32 of
    one shape. ``t`` is formed from ``x`` as the module says (``x``,
    ``affine``, or ``bounds`` f32 (M,) read by handle) and clipped to [0,
    1]. Row ``j = floor(t * max(n - 1, 1))`` of the lane's medium gives
    ``v_j + l * (v_{j+1} - v_j)`` in each table (slope 0 in the last
    column, so a table shorter than L reads its padding there); lanes
    whose table is null (n = 0) give its null value (``null_value``: a
    float, or one a table). With ``shared`` the tables are read as the
    const4 read stacks them: n the largest of their sizes, a null table
    its null value across its own width, 0 beyond a table's width. Returns
    ``x``'s shape for one table given as a tensor, else a tuple;
    differentiable in ``values`` and ``x``. One launch on the card."""
    one, tables, sizes = _packed(values, sizes)
    reader = _reader(True, tables, sizes, null_value, affine, bounds, clips, shared, x.device)
    return _read(reader, tables, sizes, bounds, handle, x, one)


def read_packed_plain(values, sizes, handle, x, null_value=0.0, *, affine=None, bounds=None, clips: int = 1,
                      shared: bool = False):
    """Plain version of :func:`read_packed`'s forward (any device)."""
    one, tables, sizes = _packed(values, sizes)
    reader = _reader(True, tables, sizes, null_value, affine, bounds, clips, shared, x.device)
    flat, h = _lanes(x, handle)
    out = reader.plain(tables, sizes, bounds, h, flat)
    return out[0].view(x.shape) if one else tuple(o.view(x.shape) for o in out)


def _packed_grad(run, values, sizes, handle, x, grad_out, null_value, affine, bounds, clips, shared,
                 need_values, need_x):
    one, tables, sizes = _packed(values, sizes)
    reader = _reader(True, tables, sizes, null_value, affine, bounds, clips, shared, x.device)
    flat, h = _lanes(x, handle)
    need = [need_values] * len(tables) if isinstance(need_values, bool) else list(need_values)
    grads, grad_x = run(reader, tables, sizes, bounds, h, flat, _grad_rows(grad_out, one, flat.shape[0]),
                        need, need_x)
    return _grads(grads, one), None if grad_x is None else grad_x.view(x.shape)


def read_packed_grad(values, sizes, handle, x, grad_out, null_value=0.0, *, affine=None, bounds=None,
                     clips: int = 1, shared: bool = False, need_values=True, need_x: bool = True):
    """Backward of :func:`read_packed`: (d values, d x), None where not
    asked for; null lanes give exact zeros. CUDA tensors launch
    ``theia_table_read_grad``, CPU tensors run the plain version."""
    return _packed_grad(_backward, values, sizes, handle, x, grad_out, null_value, affine, bounds, clips, shared,
                        need_values, need_x)


def read_packed_grad_plain(values, sizes, handle, x, grad_out, null_value=0.0, *, affine=None, bounds=None,
                           clips: int = 1, shared: bool = False, need_values=True, need_x: bool = True):
    """Plain version of :func:`read_packed_grad` (any device)."""
    return _packed_grad(_Reader.grad_plain, values, sizes, handle, x, grad_out, null_value, affine, bounds, clips,
                        shared, need_values, need_x)


read_packed.launches = 0
read_packed_grad.launches = 0


def packed_spec(values, sizes, null_value=0.0, *, affine=None, bounds=None, clips: int = 1, shared: bool = False,
                device):
    """The kernel constants (``TheiaTableSpec``, ``csrc/table_read.cuh``) of
    a :func:`read_packed` table set with these arguments, for kernels that
    read the tables at their own lanes through ``read_lane`` (the segment
    kernels of ``csrc/segment.cu``). The struct is checked as a read's is,
    and its pointers stay valid while the tables live."""
    _, tables, sizes = _packed(values, sizes)
    return _reader(True, tables, sizes, null_value, affine, bounds, clips, shared, torch.device(device)).spec


# ---------------------------------------------------------------------------
# whole rows: the hit reconstruction's tri_data and inst_data rows
# ---------------------------------------------------------------------------


#: the most spans one gather hands out; equals kMaxSpans of ``csrc/table_read.cu``
MAX_SPANS = 16


class _Spans(ctypes.Structure):
    """TheiaSpans of ``csrc/table_read.cu``, field for field."""

    _fields_ = [
        ("count", ctypes.c_int),
        ("start", ctypes.c_int * MAX_SPANS),
        ("width", ctypes.c_int * MAX_SPANS),
        ("integer", ctypes.c_int * MAX_SPANS),
    ]


def _span_set(columns, width: int):
    """``columns`` (None: the whole row) checked against rows of ``width``
    floats: ((start, stop, integer), ...) and the kernels' struct."""
    try:
        hash(columns)
    except TypeError:
        raise ValueError(f"gather_rows: columns is a tuple of tuples, got {columns!r}") from None
    return _checked_spans(columns, width)


@lru_cache(maxsize=64)
def _checked_spans(columns, width: int):
    spans = []
    for span in ((0, width),) if columns is None else columns:
        start, stop, *kind = span
        if kind not in ([], [torch.int32]) or not 0 <= start < stop <= width:
            raise ValueError(f"gather_rows: a span is (start, stop) or (start, stop, torch.int32) "
                             f"within the row's {width} columns, got {span}")
        spans.append((int(start), int(stop), bool(kind)))
    if not 1 <= len(spans) <= MAX_SPANS:
        raise ValueError(f"gather_rows: 1 to {MAX_SPANS} spans, got {len(spans)}")
    # the kernel's backward stages a row's spans into one tile, so a column belongs to one span
    ordered = sorted(spans)
    if any(b[0] < a[1] for a, b in zip(ordered, ordered[1:])):
        raise ValueError(f"gather_rows: spans must not overlap, got {columns}")
    spec = _Spans(len(spans))
    for k, (start, stop, integer) in enumerate(spans):
        spec.start[k], spec.width[k], spec.integer[k] = start, stop - start, integer
    return tuple(spans), spec


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(_ptr(t) for t in tensors))


def _gather_forward(table, index, columns):
    spans, spec = _span_set(columns, table.shape[1])
    if not _on_card(table, index):
        return gather_rows_plain(table, index, columns)
    n = index.shape[0]
    outs = tuple(
        torch.empty((n, stop - start), dtype=torch.int32 if integer else torch.float32, device=table.device)
        for start, stop, integer in spans
    )
    if n:
        _launch(gather_rows, "theia_gather_rows", table.data_ptr(), table.shape[0], table.shape[1],
                index.data_ptr(), n, ctypes.byref(spec), _pointers(outs), _build.raw_stream(table))
    return outs


def gather_rows_plain(table, index, columns=None):
    """Plain version of :func:`gather_rows`' forward (any device): one
    tensor a span, ``table[index][:, start:stop]``, the integer spans
    converted; a tuple, also without ``columns``."""
    spans, _ = _span_set(columns, table.shape[1])
    rows = [table[:, start:stop][index] for start, stop, _ in spans]
    return tuple(r.to(torch.int32) if integer else r for r, (_, _, integer) in zip(rows, spans))


def _gradients(spans, index, grad_out):
    """The spans' upstream gradients, contiguous, None where a span takes
    none (an integer span, or one not used)."""
    if len(grad_out) != len(spans):
        raise ValueError(f"gather_rows_grad: one gradient a span ({len(spans)}), got {len(grad_out)}")
    grads = []
    for g, (start, stop, integer) in zip(grad_out, spans):
        if g is None or integer:
            grads.append(None)
            continue
        if g.dtype != torch.float32 or g.shape != (index.shape[0], stop - start):
            raise ValueError(f"gather_rows_grad: the gradient of columns {start}:{stop} must be f32 "
                             f"({index.shape[0]}, {stop - start}), got {g.dtype} {tuple(g.shape)}")
        grads.append(g.contiguous())
    return grads


#: the gathers' backward (``csrc/table_read.cu``): a merging block's rows,
#: at least GATHER_MERGE_ROWS and as many as keep the ranges of rows to
#: GATHER_MOST_RANGES (kMergeRows, kMostRanges); a pass's columns
#: (kPassColumns); the rows a table may have (kMostRows: a tile's sort
#: keys are 32 bits, the row above a lane's 10)
GATHER_MERGE_ROWS, GATHER_MOST_RANGES, GATHER_PASS_COLUMNS, GATHER_MOST_ROWS = 8, 32768, 32, 1 << 22


def _gather_scratch_words(rows: int, count: int) -> int:
    """The floats of the gathers' backward scratch (grad_size of
    ``csrc/table_read.cu``): a pass's lists of each tile's rows and their
    sums, and where each range of rows starts in them."""
    tiles = -(-count // TILE_LANES)
    cap = min(rows, TILE_LANES)
    per = max(GATHER_MERGE_ROWS, -(-rows // GATHER_MOST_RANGES))
    ranges = -(-rows // per)
    return tiles * cap * (1 + GATHER_PASS_COLUMNS) + tiles * (ranges + 1)


def gather_rows_grad(shape, index, grad_out, columns=None):
    """Backward of :func:`gather_rows`: d table of ``shape`` (T, W), each
    entry the sum of the gradients of the lanes that read its row, in the
    order of the records' kind (``ops/ordered.py``; its first level a tile
    of 1024 lanes in lane order), so the same bits on every launch and on
    either device. ``grad_out`` is the (N, W) gradient
    without ``columns``, else one gradient a span, None where a span takes
    none (the integer spans take none); nothing of width W is built. CUDA
    tensors launch ``theia_gather_rows_grad`` (two launches: a tile's lanes
    sorted by row and summed in lane order, then the tiles' sums in order;
    no atomics), CPU tensors run the plain version."""
    spans, spec = _span_set(columns, shape[1])
    grads = _gradients(spans, index, (grad_out,) if columns is None else tuple(grad_out))
    present = [g for g in grads if g is not None]
    if not _on_card(index, *present):
        return _grad_plain(shape, index, spans, grads)
    n = index.shape[0]
    if not (n and present):
        return torch.zeros(shape, dtype=torch.float32, device=index.device)
    if shape[0] >= GATHER_MOST_ROWS:
        raise ValueError(f"gather_rows_grad: the card's kernel takes fewer than {GATHER_MOST_ROWS} rows, got {shape[0]}")
    grad = torch.empty(shape, dtype=torch.float32, device=index.device)
    scratch = torch.empty(_gather_scratch_words(shape[0], n), dtype=torch.float32, device=index.device)
    _launch(gather_rows_grad, "theia_gather_rows_grad", ctypes.byref(spec), _pointers(grads), index.data_ptr(), n,
            shape[0], shape[1], grad.data_ptr(), scratch.data_ptr(), scratch.numel(), _build.raw_stream(grad))
    return grad


def _grad_plain(shape, index, spans, grads):
    """Each span's gradient as items (lane, row x W + column) in lane
    order, summed in the kernel's order: a tile's lanes in lane order, then
    the tiles in groups, then the groups."""
    n, width = index.shape[0], shape[1]
    lanes, bins, values = [], [], []
    row = index.to(torch.int64)[:, None] * width
    for g, (start, stop, _) in zip(grads, spans):
        if g is None:
            continue
        cols = torch.arange(start, stop, device=index.device)
        lanes.append(torch.arange(n, device=index.device).repeat_interleave(stop - start))
        bins.append((row + cols).reshape(-1))
        values.append(g.reshape(-1))
    if not lanes:
        return torch.zeros(shape, dtype=torch.float32, device=index.device)
    lane, flat, value = (torch.cat(x) for x in (lanes, bins, values))
    live = value != 0
    return ordered_bin_sums(lane[live], flat[live], value[live], n, shape[0] * width, TILE_LANES).reshape(shape)


def gather_rows_grad_plain(shape, index, grad_out, columns=None):
    """Plain version of :func:`gather_rows_grad` (any device): the spans'
    gradients summed into a zero table in the kernel's order."""
    spans, _ = _span_set(columns, shape[1])
    grads = _gradients(spans, index, (grad_out,) if columns is None else tuple(grad_out))
    return _grad_plain(shape, index, spans, grads)


class _GatherRows(torch.autograd.Function):
    """One output a span; the integer spans are not differentiable, and an
    unused span's gradient arrives as None."""

    @staticmethod
    def forward(ctx, table, index, columns):
        outs = _gather_forward(table, index, columns)
        spans, _ = _span_set(columns, table.shape[1])
        ctx.mark_non_differentiable(*(o for o, (_, _, integer) in zip(outs, spans) if integer))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(index)
        ctx.shape, ctx.columns = table.shape, columns
        return outs

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return None, None, None
        (index,) = ctx.saved_tensors
        columns = ctx.columns or ((0, ctx.shape[1]),)
        return gather_rows_grad(ctx.shape, index, grads, columns), None, None


def gather_rows(table: torch.Tensor, index: torch.Tensor, columns=None):
    """``table[index]`` for an f32 (T, W) table and row indices (N,) in
    [0, T): the (N, W) rows, or with ``columns`` only the spans of them
    that a caller reads, one tensor a span from one launch. ``columns`` is
    a tuple of spans ``(start, stop)`` (f32 (N, stop - start)) or ``(start,
    stop, torch.int32)`` (columns that hold integers as floats, converted as
    ``.to(torch.int32)`` converts them). Differentiable in the table (a
    row's gradient sums the lanes that read it) through the float spans
    alone: an unused span adds nothing and nothing (N, W) is built. The
    scene tables' rows that ``accel._reconstruct_hit`` rebuilds a hit from
    (``TRI_COLUMNS``, ``INST_COLUMNS`` there); where ``tri_data`` or
    ``inst_data`` carries a graph (an instance moved by
    ``translate_instance``) torch's index backward sorted 262,144 lanes
    for each of them, and slicing one (N, 32) gather cost a zero (N, 32)
    tensor, a copy and an add of that width a piece. The card's kernel
    copies bit for bit. ``columns`` must be hashable (a tuple)."""
    _check("table", table, torch.float32, 2)
    index = index.to(torch.int32).contiguous()
    if index.dim() != 1:
        raise ValueError("gather_rows: index must be 1-d")
    if _differentiable(table):
        outs = _GatherRows.apply(table, index, columns)
    else:
        outs = _gather_forward(table, index, columns)
    return outs[0] if columns is None else outs


gather_rows.launches = 0
gather_rows_grad.launches = 0
