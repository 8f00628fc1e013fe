"""Hit responses: turn detector hits into recorded results.

A response owns a *state* tensor for one batch; ``record`` folds a masked
wavefront of hits into it and ``result`` applies the 1/batchSize
normalization (reference: src/theia/response.py,
shader/response.histogram.glsl, estimator.reduce.glsl:17-35).

:func:`histogram_add` is the histogram's accumulation: on CUDA tensors it
launches the record of ``csrc/histogram.cu``, on CPU tensors it runs
:func:`histogram_add_plain`. Both add in one fixed order
(:func:`ordered_bin_sums`: a warp's span of lanes, a tile of spans, groups
of tiles), so a light curve is the same bits on every run and on either
device. It is differentiable in ``value``: its backward,
:func:`histogram_grad`, gathers the state's gradient at each kept lane's
bin (the gather kernel of ``csrc/histogram.cu`` on CUDA,
:func:`histogram_grad_plain` on the CPU).

:func:`kernel_histogram_add` is the kernel histogram's (binned KDE)
accumulation, on ``csrc/kernel_histogram.cu``: each lane adds its value,
weighted by a Gaussian of its time, to the ``2 * support + 1`` bins
around its own, in the same fixed order. It is differentiable in the
value, the time and the three parameters (``t0``, ``binSize``,
``bandwidth``); its backward is :func:`kernel_histogram_grad`.
"""

from __future__ import annotations

import math
import warnings

import torch

import numpy as np

from . import _build
from .component import Component, TraceConfig, host_dict, resolve_device
from .items import (
    CameraHitResponseItem,
    HitTimeAndIdItem,
    HitTimeItem,
    PolarizedCameraHitResponseItem,
    PolarizedHitItem,
    ValueItem,
)
# the records' fixed order and its scratch (ops/ordered.py, which the
# backward kernels of ops/table_read.py take too) under their names here
from .ops.ordered import (
    RECORD_COUNTERS,
    RECORD_DENSE_CELLS,
    RECORD_MAX_RANGES,
    RECORD_RANGE,
    RECORD_STAGE,
    RECORD_TABLE_MAX,
    SPAN_LANES,
    TILE_GROUPS,
    TILE_LANES,
    _add_sums,
    _scratch_floats,
    _sparse_words,
    ordered_bin_sums,
    record_counters as _record_counters,
    record_table as _record_table,
    slot_sums,
)
from .random import RNGState
from .trace.core import HitItem

__all__ = [
    "ValueResponse",
    "UniformValueResponse",
    "CustomValueResponse",
    "HitResponse",
    "EmptyResponse",
    "HistogramHitResponse",
    "KernelHistogramHitResponse",
    "HitRecorder",
    "StoreTimeHitResponse",
    "StoreValueHitResponse",
    "SampleValueResponse",
    "Estimator",
    "HistogramEstimator",
    "HistogramReducer",
    "HostEstimator",
    "createHitTimeQueue",
    "createValueQueue",
    "replay_hits",
    "sample_camera_hits",
    "HitReplay",
    "CameraHitResponseSampler",
    # the reference's record layouts (theia_tpu_torch.items)
    "PolarizedHitItem",
    "HitTimeItem",
    "HitTimeAndIdItem",
    "ValueItem",
    "CameraHitResponseItem",
    "PolarizedCameraHitResponseItem",
    "histogram_add",
    "histogram_add_plain",
    "histogram_grad",
    "histogram_grad_plain",
    "kernel_histogram_add",
    "kernel_histogram_add_plain",
    "kernel_histogram_grad",
    "kernel_histogram_grad_plain",
]

class ValueResponse(Component):
    """Maps a HitItem to a scalar detector response value
    (reference: src/theia/response.py:444-483)."""

    name = "Value Response"
    nRNGSamples: int = 0

    def value(self, params, item: HitItem, rng: RNGState):
        raise NotImplementedError

    def prepare(self, config: TraceConfig) -> None:
        pass


class UniformValueResponse(ValueResponse):
    """Perfect isotropic, uniform response: value = contribution
    (reference: shader/response.uniform.glsl)."""

    name = "Uniform Value Response"

    def value(self, params, item: HitItem, rng: RNGState):
        return item.contrib, rng


class CustomValueResponse(ValueResponse):
    """User-provided value function ``fn(params, item, rng) -> (value, rng)``
    (reference: src/theia/response.py:498-530). ``params``: a dict whose
    numbers and arrays :meth:`params` hands to ``fn`` as float32 tensors on
    the tracer's device (tensors as they are)."""

    name = "Custom Value Response"

    def __init__(self, fn, *, nRNGSamples: int = 0, params=None) -> None:
        self._fn = fn
        self.nRNGSamples = nRNGSamples
        self._custom_params = params or {}

    def params(self, device):
        return host_dict({k: (v, np.float32) for k, v in self._custom_params.items()}, device)

    def value(self, params, item: HitItem, rng: RNGState):
        return self._fn(params, item, rng)


class HitResponse(Component):
    """Base class for hit responses (reference: src/theia/response.py:125-188)."""

    name = "Hit Response"
    nRNGSamples: int = 0

    def prepare(self, config: TraceConfig) -> None:
        """Called by the tracer during construction."""
        self._config = config

    def renormalize(self, normalization: float) -> None:
        """Hook for runtime batchSize changes."""

    def init(self, device):
        """Fresh accumulator state for one batch."""
        raise NotImplementedError

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        """Fold a masked wavefront of hits into the state."""
        raise NotImplementedError

    def result(self, params, state):
        """Finalize the batch (applies normalization)."""
        return state


class EmptyResponse(HitResponse):
    """Ignores all hits (reference: src/theia/response.py EmptyResponse)."""

    name = "Empty Response"

    def init(self, device):
        return ()

    def record(self, params, state, item, mask, rng):
        return state, rng

    def result(self, params, state):
        return None


def _hist_bins(time, mask, t0, bin_size, n_bins, object_id, n_detectors):
    """(keep, flat bin) per lane: bin = floor((t - t0) / binSize); lanes
    masked, out of [0, nBins) or with a detector id out of range are not
    kept (theia_tpu/response.py:226-234). A NaN time is not kept either,
    a deliberate divergence: ``theia_tpu`` casts the NaN bin to an
    integer, which on the CPU lands in bin 0, so a lane that carries no
    time would add its value to the first bin. The port (this rule and
    the kernels of ``csrc/histogram.cu``) drops the lane
    (tests/test_torch_response.py holds both behaviours)."""
    bin_f = torch.floor((time - t0) / bin_size)
    keep = mask & (bin_f >= 0) & (bin_f < n_bins)
    bins = torch.where(keep, bin_f, 0.0).to(torch.int64)
    if n_detectors is not None:
        det = object_id.to(torch.int64)
        keep = keep & (det >= 0) & (det < n_detectors)
        bins = bins + torch.where(keep, det, 0) * n_bins
    return keep, bins


def histogram_add_plain(
    state, value, time, mask, t0, bin_size, n_bins: int,
    object_id=None, n_detectors: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram_add` (any device): the
    kept lanes' values summed in the records' fixed order
    (:func:`ordered_bin_sums`), which the kernel keeps bit for bit."""
    keep, bins = _hist_bins(time, mask, t0, bin_size, n_bins, object_id, n_detectors)
    lane = torch.nonzero(keep).squeeze(1)
    return _add_sums(state, ordered_bin_sums(lane, bins[lane], value[lane], time.shape[0], state.shape[0]))


def _check_hist(
    state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors,
    check_value: bool = True,
):
    n = time.shape[0]
    expect = [("value", value, torch.float32, (n,))] if check_value else []
    expect += [
        ("time", time, torch.float32, (n,)),
        ("mask", mask, torch.bool, (n,)),
        ("t0", t0, torch.float32, ()),
        ("bin_size", bin_size, torch.float32, ()),
        ("state", state, torch.float32, (n_bins * (n_detectors or 1),)),
    ]
    if n_detectors is not None:
        expect.append(("object_id", object_id, torch.int32, (n,)))
    for name, a, dtype, shape in expect:
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}")
        if not a.is_contiguous() or a.device != state.device:
            raise ValueError(f"{name} must be contiguous on {state.device}")


class _HistogramAdd(torch.autograd.Function):
    """``state += scatter(value)`` with its gradient in ``state`` (the
    identity) and in ``value`` (:func:`histogram_grad`).

    The state is updated in place and marked dirty (``mark_dirty``), so
    autograd bumps its version and re-roots its history on this node; the
    backward needs none of the state's values, and no other op of the
    tracer saves the state, so the in-place update breaks no saved
    tensor. That keeps one buffer per batch where an out-of-place add
    would make a new one at every record."""

    @staticmethod
    def forward(ctx, state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors):
        if state.device.type == "cpu":
            histogram_add_plain(
                state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors
            )
        else:
            table = _record_table(value.shape[0], state.shape[0], state.device)
            err = _build.library().theia_histogram_add(
                value.data_ptr(), time.data_ptr(), mask.data_ptr(),
                object_id.data_ptr() if n_detectors is not None else None,
                t0.data_ptr(), bin_size.data_ptr(), value.shape[0], n_bins,
                n_detectors or 0, table.data_ptr(), table.numel(), _record_counters(state).data_ptr(),
                state.data_ptr(), _build.stream_handle(state.device),
            )
            _build.check(err, "histogram_add")
            histogram_add.launches += 1
        ctx.mark_dirty(state)
        ctx.save_for_backward(time, mask, t0, bin_size, object_id)
        ctx.n_bins, ctx.n_detectors = n_bins, n_detectors
        return state

    @staticmethod
    def backward(ctx, grad_state):
        time, mask, t0, bin_size, object_id = ctx.saved_tensors
        grad_value = None
        if ctx.needs_input_grad[1]:
            grad_value = histogram_grad(
                grad_state.contiguous(), time, mask, t0, bin_size, ctx.n_bins,
                object_id, ctx.n_detectors,
            )
        return (grad_state, grad_value) + (None,) * 7


def histogram_add(
    state, value, time, mask, t0, bin_size, n_bins: int,
    object_id=None, n_detectors: int | None = None,
) -> torch.Tensor:
    """Add ``value`` into ``state[det * n_bins + bin]`` in place and return
    ``state``, with bin = floor((time - t0) / bin_size); masked and
    out-of-range lanes are dropped.

    ``state``: f32 (n_bins * (n_detectors or 1),); ``value``/``time``: f32
    (N,); ``mask``: bool (N,); ``t0``/``bin_size``: f32 0-d tensors on the
    state's device; ``object_id``: i32 (N,) when ``n_detectors`` is set.
    CUDA tensors launch ``csrc/histogram.cu`` (one kernel: the tiles' sums
    into a (tiles x bins) table of scratch, the last blocks to finish the
    groups' and then the record's sums into ``state``), CPU tensors run
    the plain version. Both add in the fixed order of
    :func:`ordered_bin_sums`, so a record gives the same bits on every
    launch and on either device. The inputs may be views at any offset. Differentiable in ``value`` (and through ``state``); ``time``
    takes no gradient, as in JAX where the bins come from a floor of the
    detached time, so an attached ``time`` is refused."""
    if time.requires_grad:
        raise ValueError("histogram_add takes no gradient in time: pass time.detach()")
    _check_hist(state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors)
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"histogram_add: unsupported device {state.device}")
    return _HistogramAdd.apply(
        state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors
    )


histogram_add.launches = 0


def histogram_grad_plain(
    grad_state, time, mask, t0, bin_size, n_bins: int,
    object_id=None, n_detectors: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram_grad` (any device)."""
    keep, bins = _hist_bins(time, mask, t0, bin_size, n_bins, object_id, n_detectors)
    return torch.where(keep, grad_state[bins], 0.0)


def histogram_grad(
    grad_state, time, mask, t0, bin_size, n_bins: int,
    object_id=None, n_detectors: int | None = None,
) -> torch.Tensor:
    """Backward of :func:`histogram_add` in ``value``: returns f32 (N,)
    ``grad_state[det * n_bins + bin]`` on kept lanes and 0 on dropped
    ones, with the forward's bins. CUDA tensors launch the gather kernel
    of ``csrc/histogram.cu`` (bit-equal to the plain version: it sums
    nothing), CPU tensors run the plain version."""
    n = time.shape[0]
    _check_hist(
        grad_state, None, time, mask, t0, bin_size, n_bins, object_id, n_detectors,
        check_value=False,
    )
    if grad_state.device.type == "cpu":
        return histogram_grad_plain(
            grad_state, time, mask, t0, bin_size, n_bins, object_id, n_detectors
        )
    if grad_state.device.type != "cuda":
        raise ValueError(f"histogram_grad: unsupported device {grad_state.device}")
    grad_value = torch.empty(n, dtype=torch.float32, device=grad_state.device)
    err = _build.library().theia_histogram_grad(
        grad_state.data_ptr(), time.data_ptr(), mask.data_ptr(),
        object_id.data_ptr() if n_detectors is not None else None,
        t0.data_ptr(), bin_size.data_ptr(), n, n_bins, n_detectors or 0,
        grad_value.data_ptr(), _build.stream_handle(grad_state.device),
    )
    _build.check(err, "histogram_grad")
    histogram_grad.launches += 1
    return grad_value


histogram_grad.launches = 0


class HistogramHitResponse(HitResponse):
    """Time-binned histogram of response values — the light curve
    (reference: src/theia/response.py:1200-1421,
    shader/response.histogram.glsl:16-68).

    ``nDetectors``: when set, hits are additionally binned by their
    detector/object id into an (nDetectors, nBins) array (ids outside
    [0, nDetectors) are dropped)."""

    name = "Histogram Hit Response"
    _param_names = ("t0", "binSize")

    def __init__(
        self,
        value_response: ValueResponse | None = None,
        *,
        nBins: int = 100,
        t0: float = 0.0,
        binSize: float = 1.0,
        normalization: float | None = None,
        nDetectors: int | None = None,
    ) -> None:
        self.value_response = (
            UniformValueResponse() if value_response is None else value_response
        )
        if nBins < 1:
            raise ValueError("nBins must be >= 1")
        if nDetectors is not None and nDetectors < 1:
            raise ValueError("nDetectors must be >= 1 (or None for no detector axis)")
        self.nBins = nBins
        self.t0 = t0
        self.binSize = binSize
        self.nDetectors = nDetectors
        self._normalization = normalization
        self._auto_norm = False
        self.nRNGSamples = self.value_response.nRNGSamples

    def params(self, device):
        p = super().params(device)
        p["value"] = self.value_response.params(device)
        return p

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)
        if self._normalization is None:
            self._normalization = config.normalization
            self._auto_norm = True

    def renormalize(self, normalization: float) -> None:
        if self._auto_norm:
            self._normalization = normalization

    def init(self, device):
        return torch.zeros(
            self.nBins * (self.nDetectors or 1), dtype=torch.float32, device=device
        )

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        """Adds the masked hits into ``state`` in place; returns
        (state, rng)."""
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        state = histogram_add(
            state,
            value.contiguous(),
            item.time.detach().contiguous(),
            mask.contiguous(),
            params["t0"],
            params["binSize"],
            self.nBins,
            item.object_id.contiguous() if self.nDetectors is not None else None,
            self.nDetectors,
        )
        return state, rng

    def result(self, params, state):
        out = state * float(self._normalization)
        if self.nDetectors is not None:
            out = out.reshape(self.nDetectors, self.nBins)
        return out


#: sqrt(2 pi) as float32, as ``jnp.sqrt(2.0 * jnp.pi)`` rounds it
_SQRT_2PI = float(torch.tensor(2.0 * math.pi, dtype=torch.float32).sqrt())


#: the record's exp (``csrc/kernel_histogram.cu`` kde_exp): 1 / ln 2, ln 2
#: in two parts and Cephes' expf polynomial, each a float32
_EXP_F32 = tuple(float(np.float32(c)) for c in (
    1.44269504088896341, 0.693359375, -2.12194440e-4,
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1,
))


def _kde_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of the kernel histogram's float32 ``x = -z^2 / 2`` as the
    kernel's kde_exp computes it, op for op in float32: n = round(x / ln 2),
    r = (x - n ln2_hi) - n ln2_lo, e^r = (p(r) r^2 + r) + 1 by Cephes' expf
    polynomial in Horner's form, times 2^n as two powers of two made from
    their bits (a subnormal result rounds once); 0 below -104. Separate
    products and sums on either side, so the kernel's weights equal these
    bit for bit, where the card's expf and the CPU's exp are an ulp apart
    on many inputs. Within an ulp of exp. Differentiable: its slope is the
    polynomial's."""
    inv_ln2, ln2_hi, ln2_lo, *poly = _EXP_F32
    n = torch.round(x * inv_ln2)
    r = (x - n * ln2_hi) - n * ln2_lo
    p = torch.full_like(x, poly[0])
    for c in poly[1:]:
        p = p * r + c
    y = (p * (r * r) + r) + 1.0
    e = torch.where(torch.isnan(n), 0.0, n.detach()).to(torch.int32)
    half = torch.div(e, 2, rounding_mode="trunc")
    scale = lambda k: ((k + 127) << 23).view(torch.float32)
    return torch.where(x < -104.0, 0.0, (y * scale(half)) * scale(e - half))


def _kde_terms(time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors, exp=_kde_exp):
    """Per offset of the kernel's support: (kept, flat bin, bin centre,
    z = (centre - t) / h, E = exp(-z^2 / 2)), in the ops and order of
    ``theia_tpu``'s record; ``exp`` the record's (:func:`_kde_exp`) or,
    for the backward, ``torch.exp``, whose card version is the backward
    kernel's expf. The bins come from the detached time; a lane
    is dropped where it is masked, where its centre ``(t - t0) / binSize``
    is not finite (a NaN or infinite time; ``theia_tpu`` casts such a
    centre to an integer, see :func:`kernel_histogram_add`) or, with a
    detector axis, where its id is out of range; a bin where it is out
    of [0, nBins)."""
    center = (time.detach() - t0) / bin_size
    base = torch.floor(center)
    lane = mask & torch.isfinite(center)
    if n_detectors is not None:
        det = object_id.to(torch.int64)
        lane = lane & (det >= 0) & (det < n_detectors)
        offset = torch.where(lane, det, 0) * n_bins
    terms = []
    for off in range(-support, support + 1):
        bin_f = base + float(off)
        keep = lane & (bin_f >= 0) & (bin_f < n_bins)
        flat = torch.where(keep, bin_f, 0.0).to(torch.int64)
        if n_detectors is not None:
            flat = flat + offset
        bc = (bin_f + 0.5) * bin_size + t0
        z = (bc - time) / bandwidth
        terms.append((keep, flat, bin_f, z, exp(-0.5 * (z * z))))
    return terms


def kernel_histogram_add_plain(
    state, value, time, mask, t0, bin_size, bandwidth, n_bins: int, support: int = 4,
    object_id=None, n_detectors: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`kernel_histogram_add` (any device; adds in
    place and returns ``state``): the (lane, bin) pairs summed in the
    records' fixed order (:func:`ordered_bin_sums`; in a span's row of 32
    lanes the offsets from ``-support`` up, for each the lanes in order),
    which the kernel keeps bit for bit."""
    norm = bin_size / (bandwidth * _SQRT_2PI)
    slots = [
        (flat, value * (e * norm), keep)
        for keep, flat, _, _, e in _kde_terms(time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors)
    ]
    return _add_sums(state, slot_sums(slots, time.shape[0], state.shape[0]))


def kernel_histogram_grad_plain(
    grad_state, value, time, mask, t0, bin_size, bandwidth, n_bins: int, support: int = 4,
    object_id=None, n_detectors: int | None = None,
):
    """Plain version of :func:`kernel_histogram_grad`: (d value, d time,
    d t0, d binSize, d bandwidth), the kernel's float32 ops in its order
    (``torch.exp``: the kernel's expf on the card), a lane's bins from
    ``-support`` up; the three scalars its terms (d t0's the lane's ``- d
    time``) summed over the kept lanes in the records' fixed order
    (:func:`ordered_bin_sums`, three bins), which the kernel keeps bit for
    bit."""
    h = bandwidth
    inv = 1.0 / (h * _SQRT_2PI)
    norm = bin_size * inv
    grad_value = torch.zeros_like(time)
    grad_time = torch.zeros_like(time)
    grad_bs = torch.zeros_like(time)
    grad_h = torch.zeros_like(time)
    any_kept = torch.zeros_like(mask)
    for keep, flat, bin_f, z, e in _kde_terms(
        time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors, torch.exp
    ):
        # a dropped lane's terms may be 0 * inf: select, never multiply by 0
        kept = lambda a: torch.where(keep, a, 0.0)
        g = grad_state[flat]
        w = e * norm
        gv = g * value
        grad_value = grad_value + kept(g * w)
        grad_time = grad_time + kept(gv * w * z / h)
        grad_bs = grad_bs + kept(gv * (e * inv - w * z * (bin_f + 0.5) / h))
        grad_h = grad_h + kept(gv * w * (z * z - 1.0) / h)
        any_kept = any_kept | keep
    lane = torch.nonzero(any_kept).squeeze(1)
    items = torch.stack([-grad_time[lane], grad_bs[lane], grad_h[lane]], 1).reshape(-1)
    scalars = ordered_bin_sums(lane.repeat_interleave(3), torch.arange(3, device=time.device).repeat(lane.shape[0]),
                               items, time.shape[0], 3)
    return grad_value, grad_time, *scalars.unbind()


def _check_kde(state, value, time, mask, params, n_bins, object_id, n_detectors):
    _check_hist(state, value, time.detach(), mask, params[0], params[1], n_bins, object_id, n_detectors)
    if params[2].dtype != torch.float32 or params[2].shape != () or params[2].device != state.device:
        raise ValueError(f"bandwidth must be a 0-d torch.float32 tensor on {state.device}")


def _kde_args(time, mask, object_id, n_detectors, t0, bin_size, bandwidth, n_bins, support):
    """The lanes' part of the two C entry points' arguments."""
    return (
        time.data_ptr(), mask.data_ptr(),
        object_id.data_ptr() if n_detectors is not None else None,
        t0.data_ptr(), bin_size.data_ptr(), bandwidth.data_ptr(),
        time.shape[0], n_bins, n_detectors or 0, support,
    )


def _kde_forward(state, value, time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors):
    if state.device.type == "cpu":
        return kernel_histogram_add_plain(
            state, value, time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors
        )
    if time.shape[0]:
        table = _record_table(time.shape[0], state.shape[0], state.device, 2 * support + 1)
        err = _build.library().theia_kde_add(
            value.data_ptr(),
            *_kde_args(time, mask, object_id, n_detectors, t0, bin_size, bandwidth, n_bins, support),
            table.data_ptr(), table.numel(), _record_counters(state).data_ptr(), state.data_ptr(),
            _build.stream_handle(state.device),
        )
        _build.check(err, "kernel_histogram_add")
        kernel_histogram_add.launches += 1
    return state


class _KernelHistogramAdd(torch.autograd.Function):
    """``state += KDE(value, time)`` in place, marked dirty as in
    :class:`_HistogramAdd`: the state's gradient passes through as the
    identity, the other five come from :func:`kernel_histogram_grad`."""

    @staticmethod
    def forward(ctx, state, value, time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors):
        _kde_forward(state, value, time.detach(), mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors)
        ctx.mark_dirty(state)
        ctx.save_for_backward(value, time, mask, t0, bin_size, bandwidth, object_id)
        ctx.static = (n_bins, support, n_detectors)
        return state

    @staticmethod
    def backward(ctx, grad_state):
        value, time, mask, t0, bin_size, bandwidth, object_id = ctx.saved_tensors
        n_bins, support, n_detectors = ctx.static
        need = ctx.needs_input_grad
        grads = kernel_histogram_grad(
            grad_state.contiguous(), value, time.detach(), mask, t0, bin_size, bandwidth, n_bins, support,
            object_id, n_detectors, need_lanes=need[1] or need[2], need_params=any(need[4:7]),
        )
        grads = [g if n else None for g, n in zip(grads, (need[1], need[2], *need[4:7]))]
        return (grad_state, grads[0], grads[1], None, *grads[2:], None, None, None, None)


def kernel_histogram_add(
    state, value, time, mask, t0, bin_size, bandwidth, n_bins: int, support: int = 4,
    object_id=None, n_detectors: int | None = None,
) -> torch.Tensor:
    """The kernel histogram's record: for each kept lane and each bin
    ``b`` of ``floor(c) - support .. floor(c) + support``, ``c = (t - t0)
    / binSize`` taken on the detached time, add ``value * w_b`` to
    ``state[det * n_bins + b]`` in place, with ``w_b = exp(-((bc_b - t) /
    h)^2 / 2) * binSize / (h * sqrt(2 pi))`` at the bin centre ``bc_b =
    (b + 1/2) * binSize + t0``, as ``theia_tpu``'s record does in 2 *
    support + 1 scatter-adds. Bins out of [0, n_bins), masked lanes and
    ids out of [0, n_detectors) are dropped. A lane whose centre is not
    finite (a NaN or infinite time) is dropped too, with a zero gradient:
    ``theia_tpu`` casts such a centre to an integer, which on the CPU can
    land in a bin (NaN) and makes its gradient 0 * inf (both behaviours
    are held by tests/test_torch_kernel_histogram.py).

    ``state``: f32 (n_bins * (n_detectors or 1),); ``value``/``time``: f32
    (N,); ``mask``: bool (N,); ``t0``/``bin_size``/``bandwidth``: f32 0-d
    tensors on the state's device; ``object_id``: i32 (N,) with
    ``n_detectors``. Differentiable in ``value``, ``time``, ``t0``,
    ``bin_size`` and ``bandwidth`` (and through ``state`` as the
    identity); saves nothing where no gradient is asked for. CUDA tensors
    launch ``csrc/kernel_histogram.cu`` (one kernel, as
    :func:`histogram_add`'s), CPU tensors run the plain version; both add
    the pairs in the fixed order of :func:`kernel_histogram_add_plain`, so a
    record gives the same bits on every launch and on either device."""
    params = (t0, bin_size, bandwidth)
    _check_kde(state, value, time, mask, params, n_bins, object_id, n_detectors)
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel_histogram_add: unsupported device {state.device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (value, time, *params)):
        return _KernelHistogramAdd.apply(
            state, value, time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors
        )
    return _kde_forward(
        state, value, time.detach(), mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors
    )


kernel_histogram_add.launches = 0


def kernel_histogram_grad(
    grad_state, value, time, mask, t0, bin_size, bandwidth, n_bins: int, support: int = 4,
    object_id=None, n_detectors: int | None = None, *, need_lanes: bool = True,
    need_params: bool = True,
):
    """Backward of :func:`kernel_histogram_add`: (d value, d time, d t0,
    d binSize, d bandwidth) for the state's gradient ``grad_state``, with
    ``g_b = grad_state[flat bin]`` on kept bins: d value = sum_b g_b w_b,
    d time = sum_b g_b value w_b z_b / h (z_b = (bc_b - t) / h), d t0 = -
    sum of d time over the lanes, d binSize and d bandwidth the sums of
    the weights' derivatives. Dropped lanes get exact zeros. The lanes'
    two are None unless ``need_lanes``, the three scalars unless
    ``need_params``. CUDA tensors launch ``theia_kde_grad`` (a lane's two
    written a thread, the scalars' terms summed in the records' fixed
    order, no atomics: the same bits on every launch, equal to the plain
    version's), CPU tensors run the plain version."""
    _check_kde(grad_state, value, time, mask, (t0, bin_size, bandwidth), n_bins, object_id, n_detectors)
    if grad_state.device.type == "cpu":
        grads = kernel_histogram_grad_plain(
            grad_state, value, time, mask, t0, bin_size, bandwidth, n_bins, support, object_id, n_detectors
        )
        return (*(grads[:2] if need_lanes else (None, None)), *(grads[2:] if need_params else (None,) * 3))
    if grad_state.device.type != "cuda":
        raise ValueError(f"kernel_histogram_grad: unsupported device {grad_state.device}")
    n = time.shape[0]
    lanes = (torch.empty_like(time), torch.empty_like(time)) if need_lanes else (None, None)
    scalars = torch.zeros(3, dtype=torch.float32, device=grad_state.device) if need_params else None
    if n and (need_lanes or need_params):
        table = _record_table(n, 3, grad_state.device, 3) if need_params else None
        err = _build.library().theia_kde_grad(
            grad_state.data_ptr(), value.data_ptr(),
            *_kde_args(time, mask, object_id, n_detectors, t0, bin_size, bandwidth, n_bins, support),
            *(None if a is None else a.data_ptr() for a in (*lanes, scalars, table)),
            0 if table is None else table.numel(),
            _record_counters(grad_state).data_ptr() if need_params else None,
            _build.stream_handle(grad_state.device),
        )
        _build.check(err, "kernel_histogram_grad")
        kernel_histogram_grad.launches += 1
    elif need_lanes:
        lanes = (torch.zeros_like(time), torch.zeros_like(time))
    return (*lanes, *(scalars.unbind() if need_params else (None,) * 3))


kernel_histogram_grad.launches = 0


class KernelHistogramHitResponse(HistogramHitResponse):
    """Histogram with Gaussian kernel smearing (binned KDE), which also
    gives a smooth, differentiable dependence on arrival time
    (reference: src/theia/response.py:1424-1673,
    shader/response.histogram.kernel.glsl). ``support``: the kernel's
    reach in bins on either side (static). Its record,
    :func:`kernel_histogram_add`, is differentiable in the hit's value and
    time and in ``t0``, ``binSize`` and ``bandwidth``."""

    name = "Kernel Histogram Hit Response"
    _param_names = ("t0", "binSize", "bandwidth")

    def __init__(
        self,
        value_response: ValueResponse | None = None,
        *,
        nBins: int = 100,
        t0: float = 0.0,
        binSize: float = 1.0,
        bandwidth: float = 1.0,
        support: int = 4,
        normalization: float | None = None,
        nDetectors: int | None = None,
    ) -> None:
        super().__init__(
            value_response, nBins=nBins, t0=t0, binSize=binSize,
            normalization=normalization, nDetectors=nDetectors,
        )
        self.bandwidth = bandwidth
        self.support = support

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        """Adds the masked hits into ``state`` in place; returns
        (state, rng)."""
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        state = kernel_histogram_add(
            state,
            value.contiguous(),
            item.time.contiguous(),
            mask.contiguous(),
            params["t0"],
            params["binSize"],
            params["bandwidth"],
            self.nBins,
            self.support,
            item.object_id.contiguous() if self.nDetectors is not None else None,
            self.nDetectors,
        )
        return state, rng


#: the stored fields of the two queues of records: name -> (row shape, dtype)
_TIME_FIELDS = dict(time=((), torch.float32), objectId=((), torch.int32))
_VALUE_FIELDS = dict(value=((), torch.float32), time=((), torch.float32))


class _SlotQueue(HitResponse):
    """Stores accepted hits in slots of a fixed buffer, record-call-major:
    a record puts its accepted lanes at ``cursor + cumsum(accept) - 1`` in
    lane order, as ``theia_tpu``'s queues do (the reference's atomic
    counter queue, hephaistos.queue), and counts the hits past the
    capacity as ``overflow``. Each buffer has one row more than the
    capacity, the drop slot, which takes every rejected or overflowing
    lane, so a record is an in-place scatter that never waits for the
    device; :meth:`result` cuts the slot off."""

    def _init_queue(self, device, fields) -> dict:
        n = self._capacity + 1
        state = dict(
            cursor=torch.zeros((), dtype=torch.int64, device=device),
            overflow=torch.zeros((), dtype=torch.int64, device=device),
            valid=torch.zeros(n, dtype=torch.bool, device=device),
        )
        for name, (width, dtype) in fields.items():
            state[name] = torch.zeros((n, *width), dtype=dtype, device=device)
        return state

    def _push(self, state, accept, values) -> dict:
        cursor = state["cursor"]
        slot = cursor + torch.cumsum(accept, 0, dtype=torch.int64) - 1
        slot = torch.where(accept, torch.clamp_max(slot, self._capacity), self._capacity)
        total = cursor + accept.sum(dtype=torch.int64)
        new = dict(
            cursor=torch.clamp_max(total, self._capacity),
            overflow=state["overflow"] + torch.clamp_min(total - self._capacity, 0),
        )
        for name, value in dict(valid=accept, **values).items():
            new[name] = state[name].index_copy_(0, slot, value.detach().to(state[name].dtype))
        return new

    def _result(self, state, what: str) -> dict:
        dropped = int(state["overflow"])
        if dropped > 0:
            warnings.warn(
                f"{type(self).__name__} overflow: {dropped} {what} dropped past the "
                f"capacity of {self._capacity}; raise maxHitsPerThread"
            )
        return {k: v if v.dim() == 0 else v[: self._capacity] for k, v in state.items()}


class HitRecorder(_SlotQueue):
    """Stores raw hits for host retrieval; slots are deterministic
    (record-call-major) rather than an atomic-counter queue
    (reference: src/theia/response.py:191-275). The result is a dict of
    (capacity, ...) tensors plus a ``valid`` mask, ``cursor`` and
    ``overflow``."""

    name = "Hit Recorder"

    def __init__(self, *, polarized: bool = False) -> None:
        self.polarized = polarized

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self._capacity = config.capacity * config.max_hits_per_thread

    def _fields(self) -> dict:
        f32, i32 = torch.float32, torch.int32
        fields = dict(
            position=((3,), f32), direction=((3,), f32), normal=((3,), f32),
            wavelength=((), f32), time=((), f32), contrib=((), f32), objectId=((), i32),
        )
        if self._config.polarized:
            fields.update(stokes=((4,), f32), polRef=((3,), f32))
        return fields

    def init(self, device):
        return self._init_queue(device, self._fields())

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        values = dict(
            position=item.position, direction=item.direction, normal=item.normal,
            wavelength=item.wavelength, time=item.time, contrib=item.contrib,
            objectId=item.object_id,
        )
        if "stokes" in state:
            values.update(stokes=item.stokes, polRef=item.pol_ref)
        return self._push(state, mask, values), rng

    def result(self, params, state):
        return self._result(state, "hits")


class StoreTimeHitResponse(_SlotQueue):
    """Photon-mode sampler: accepts each hit with probability equal to its
    response value (one draw a record) and stores its arrival time,
    turning radiance contributions into discrete photon detections
    (reference: src/theia/response.py:656-797,
    shader/response.time.store.glsl)."""

    name = "Store Time Hit Response"

    def __init__(self, value_response: ValueResponse | None = None) -> None:
        self.value_response = (
            UniformValueResponse() if value_response is None else value_response
        )
        self.nRNGSamples = self.value_response.nRNGSamples + 1

    def params(self, device):
        return {"value": self.value_response.params(device)}

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)
        self._capacity = config.capacity * config.max_hits_per_thread

    def init(self, device):
        return self._init_queue(device, _TIME_FIELDS)

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        uu, rng = rng.uniform()
        accept = mask & (uu < value)
        return self._push(state, accept, dict(time=item.time, objectId=item.object_id)), rng

    def result(self, params, state):
        return self._result(state, "detections")


class StoreValueHitResponse(_SlotQueue):
    """Stores each hit's (value, time) in a queue, the input of
    :class:`HistogramEstimator` and :class:`HostEstimator`; slots as
    :class:`HitRecorder`'s (reference: src/theia/response.py:532-623)."""

    name = "Store Value Hit Response"

    def __init__(self, value_response: ValueResponse | None = None) -> None:
        self.value_response = UniformValueResponse() if value_response is None else value_response
        self.nRNGSamples = self.value_response.nRNGSamples

    def params(self, device):
        return {"value": self.value_response.params(device)}

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)
        self._capacity = config.capacity * config.max_hits_per_thread

    def init(self, device):
        return self._init_queue(device, _VALUE_FIELDS)

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        return self._push(state, mask, dict(value=value, time=item.time)), rng

    def result(self, params, state):
        return self._result(state, "hits")


class SampleValueResponse(HitResponse):
    """A lane's response value of the first hit it records: a (capacity,)
    tensor, NaN where a lane recorded none (testing detector models;
    reference: src/theia/response.py:800-881)."""

    name = "Sample Value Response"

    def __init__(self, value_response: ValueResponse | None = None) -> None:
        self.value_response = UniformValueResponse() if value_response is None else value_response
        self.nRNGSamples = self.value_response.nRNGSamples

    def params(self, device):
        return {"value": self.value_response.params(device)}

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)

    def init(self, device):
        return torch.full((self._config.capacity,), torch.nan, dtype=torch.float32, device=device)

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        return torch.where(mask & torch.isnan(state), value, state), rng


class Estimator:
    """Base class for estimators that turn a (value, time) queue into a
    final output (reference: src/theia/response.py:1676-1718)."""

    def __call__(self, queue):  # pragma: no cover - interface
        raise NotImplementedError


class HistogramReducer:
    """Reduces a stack of partial histograms into one, times the
    normalization (reference: src/theia/response.py:1065-1180,
    estimator.reduce.glsl: a workgroup reduction of partials; here one
    differentiable sum)."""

    def __init__(self, *, nBins: int = 100, normalization: float = 1.0):
        self.nBins = nBins
        self.normalization = normalization

    def __call__(self, hists):
        hists = torch.as_tensor(hists).reshape(-1, self.nBins)
        return hists.sum(dim=0) * self.normalization


def _queue(capacity: int, fields: dict, device) -> dict:
    device = resolve_device(device)
    queue = dict(
        cursor=torch.zeros((), dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.int64, device=device),
        valid=torch.zeros(capacity + 1, dtype=torch.bool, device=device),
    )
    for name, (width, dtype) in fields.items():
        queue[name] = torch.zeros((capacity + 1, *width), dtype=dtype, device=device)
    return queue


def createHitTimeQueue(capacity: int, *, objectId: bool = True, device="cuda") -> dict:
    """An empty queue of :class:`StoreTimeHitResponse`'s layout (reference:
    src/theia/response.py:638-652; ``items.HitTimeAndIdItem`` /
    ``items.HitTimeItem`` describe a record): the state its ``init`` makes
    for a tracer of ``capacity`` slots (lanes x maxHitsPerThread), each
    buffer one row longer than ``capacity`` (the drop slot that takes
    rejected and overflowing lanes, which ``result`` cuts off), with
    ``cursor`` and ``overflow``. ``objectId=False`` leaves out the ids."""
    fields = _TIME_FIELDS if objectId else dict(time=_TIME_FIELDS["time"])
    return _queue(capacity, fields, device)


def createValueQueue(capacity: int, *, device="cuda") -> dict:
    """An empty queue of :class:`StoreValueHitResponse`'s layout, the input
    of the estimators (reference: src/theia/response.py:434-441;
    ``items.ValueItem`` describes a record). ``theia_tpu``'s has
    ``capacity`` rows and a ``cursor``; this one is the port's queue state
    as ``StoreValueHitResponse.init`` makes it for a tracer of ``capacity``
    slots: ``value``, ``time`` and ``valid`` of ``capacity + 1`` rows (the
    drop slot last), ``cursor`` and ``overflow``. ``result`` cuts the drop
    slot off; the estimators take either, since the drop slot counts only
    where ``valid`` is set, which a result never has past ``capacity``."""
    return _queue(capacity, _VALUE_FIELDS, device)


def _valid_rows(queue) -> tuple[np.ndarray, np.ndarray]:
    """(value, time) of a queue's valid rows on the host, float64 values."""
    host = lambda key: queue[key].detach().cpu().numpy() if hasattr(queue[key], "detach") else np.asarray(queue[key])
    valid = host("valid").astype(bool)
    return host("value")[valid], host("time")[valid]


class HistogramEstimator(Estimator):
    """Turns a (value, time) queue into a time histogram on the host
    (reference: src/theia/response.py:1721-1850, shader/estimator.hist.glsl)."""

    def __init__(self, *, nBins: int = 100, t0: float = 0.0, binSize: float = 1.0, normalization: float = 1.0):
        self.nBins = nBins
        self.t0 = t0
        self.binSize = binSize
        self.normalization = normalization

    def __call__(self, queue) -> np.ndarray:
        value, time = _valid_rows(queue)
        hist, _ = np.histogram(
            time, bins=self.nBins, range=(self.t0, self.t0 + self.nBins * self.binSize),
            weights=value.astype(np.float64),
        )
        return hist * self.normalization


class HostEstimator:
    """The (value, time) queue's valid rows as host arrays
    (reference: src/theia/response.py:1853-1905)."""

    def __call__(self, queue):
        value, time = _valid_rows(queue)
        return {"value": value, "time": time}


def _drive(response: HitResponse, item: HitItem, mask, rng: RNGState, params=None):
    """One record of ``item`` into a fresh state of ``response``, prepared
    for one slot a lane; returns its result."""
    n = mask.shape[0]
    response.prepare(TraceConfig(batch_size=n, capacity=n, max_hits_per_thread=1, normalization=1.0,
                                 polarized=item.stokes is not None))
    params = response.params(mask.device) if params is None else params
    state, _ = response.record(params, response.init(mask.device), item, mask, rng)
    return response.result(params, state)


def replay_hits(hits: dict, response: HitResponse, params=None, *, rng=None, device=None):
    """Feeds stored hits (a :class:`HitRecorder` result) back through any
    response (reference: src/theia/response.py:278-422 HitReplay). The hits
    go to ``device``, by default the device of their tensors (the card for
    host arrays); ``rng`` (default ``PhiloxRNG(key=0xC0FFEE)``) gives the
    response's draws, stream = slot."""
    from .random import PhiloxRNG

    if device is None:
        device = hits["valid"].device if hasattr(hits["valid"], "device") else "cuda"
    device = resolve_device(device)
    get = lambda key: torch.as_tensor(hits[key], device=device)
    valid = get("valid").to(torch.bool)
    item = HitItem(
        position=get("position"), direction=get("direction"), normal=get("normal"),
        wavelength=get("wavelength"), time=get("time"), contrib=get("contrib"),
        object_id=get("objectId").to(torch.int32),
        stokes=get("stokes") if "stokes" in hits else None,
        pol_ref=get("polRef") if "polRef" in hits else None,
    )
    rng = rng if rng is not None else PhiloxRNG(key=0xC0FFEE)
    lanes = rng.state(torch.arange(valid.shape[0], dtype=torch.int32, device=device))
    return _drive(response, item, valid, lanes, params)


def sample_camera_hits(camera, response: HitResponse, n: int, *, wavelength=450.0, rng=None, device="cuda"):
    """Drives a response with ``n`` camera-sampled hits at one wavelength
    (testing detector models; reference: src/theia/response.py:908-1062
    CameraHitResponseSampler); ``rng`` defaults to
    ``PhiloxRNG(key=0xC0FFEE)``, stream = lane."""
    from .random import PhiloxRNG

    device = resolve_device(device)
    rng = rng if rng is not None else PhiloxRNG(key=0xC0FFEE)
    state = rng.state(torch.arange(n, dtype=torch.int32, device=device))
    lam = torch.full((n,), wavelength, dtype=torch.float32, device=device)
    ray, state = camera.sample_ray(camera.params(device), lam, state)
    item = HitItem(
        position=ray.hit_position, direction=ray.hit_direction, normal=ray.hit_normal, wavelength=lam,
        time=ray.time_delta, contrib=ray.contrib, object_id=ray.object_id,
    )
    return _drive(response, item, torch.ones(n, dtype=torch.bool, device=device), state)


# the reference's names (src/theia/response.py API)
HitReplay = replay_hits
CameraHitResponseSampler = sample_camera_hits
