"""Hit responses: turn detector hits into recorded results.

A response owns a *state* tensor for one batch; ``record`` folds a masked
wavefront of hits into it and ``result`` applies the 1/batchSize
normalization (reference: src/theia/response.py,
shader/response.histogram.glsl, estimator.reduce.glsl:17-35).

:func:`histogram_add` is the histogram's accumulation: on CUDA tensors it
launches a kernel of ``csrc/histogram.cu`` (a block-private histogram in
shared memory for states of up to :data:`SHARED_STATE_MAX` flat bins, adds
merged by warp straight to the state above), on CPU tensors it runs
:func:`histogram_add_plain`. It is differentiable in ``value``: its
backward, :func:`histogram_grad`, gathers the state's gradient at each
kept lane's bin (the gather kernel of ``csrc/histogram.cu`` on CUDA,
:func:`histogram_grad_plain` on the CPU).
"""

from __future__ import annotations

import warnings

import torch

from . import _build
from .component import Component, TraceConfig
from .random import RNGState
from .trace.core import HitItem

__all__ = [
    "ValueResponse",
    "UniformValueResponse",
    "HitResponse",
    "HistogramHitResponse",
    "HitRecorder",
    "StoreTimeHitResponse",
    "histogram_add",
    "histogram_add_plain",
    "histogram_grad",
    "histogram_grad_plain",
    "SHARED_STATE_MAX",
]

#: the largest state (flat bins) that the record's kernel keeps as a
#: block-private histogram in shared memory: 226 KB of floats; equals
#: kSharedMaxFloats of ``csrc/histogram.cu``
SHARED_STATE_MAX = 57_856


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
    """Plain PyTorch version of :func:`histogram_add` (any device)."""
    keep, bins = _hist_bins(time, mask, t0, bin_size, n_bins, object_id, n_detectors)
    return state.index_add_(0, bins[keep], value[keep])


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
            err = _build.library().theia_histogram_add(
                value.data_ptr(), time.data_ptr(), mask.data_ptr(),
                object_id.data_ptr() if n_detectors is not None else None,
                t0.data_ptr(), bin_size.data_ptr(), value.shape[0], n_bins,
                n_detectors or 0, state.data_ptr(), _build.stream_handle(state.device),
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
    CUDA tensors launch ``csrc/histogram.cu``, CPU tensors run the plain
    version. Which of the kernel's two variants runs follows from the
    state's size alone: up to :data:`SHARED_STATE_MAX` flat bins each
    block sums into a histogram of its own in shared memory and then adds
    its non-zero bins to ``state``; above, lanes add straight to ``state``
    after the lanes of a warp that share a bin are merged. The inputs may
    be views at any offset (the kernel reads 16 bytes at a time only where
    every pointer allows it). Atomic adds land in an order that changes
    from run to run, so a bin agrees with a sequential sum to float32
    rounding only. Differentiable in ``value`` (and through ``state``); ``time``
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
        return self._init_queue(device, dict(time=((), torch.float32), objectId=((), torch.int32)))

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        uu, rng = rng.uniform()
        accept = mask & (uu < value)
        return self._push(state, accept, dict(time=item.time, objectId=item.object_id)), rng

    def result(self, params, state):
        return self._result(state, "detections")
