"""Hit responses: turn detector hits into recorded results.

A response owns a *state* tensor for one batch; ``record`` folds a masked
wavefront of hits into it and ``result`` applies the 1/batchSize
normalization (reference: src/theia/response.py,
shader/response.histogram.glsl, estimator.reduce.glsl:17-35).

:func:`histogram_add` is the histogram's accumulation: on CUDA tensors it
launches the atomic-add kernel of ``csrc/histogram.cu``, on CPU tensors it
runs :func:`histogram_add_plain`.
"""

from __future__ import annotations

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
    "histogram_add",
    "histogram_add_plain",
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
    kept (theia_tpu/response.py:226-234)."""
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


def _check_hist(state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors):
    n = value.shape[0]
    expect = [
        ("value", value, torch.float32, (n,)),
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
    version. Gradients through the response are not ported yet."""
    if value.requires_grad:
        raise NotImplementedError("histogram_add takes no gradient yet")
    _check_hist(state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors)
    if state.device.type == "cpu":
        return histogram_add_plain(
            state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors
        )
    if state.device.type != "cuda":
        raise ValueError(f"histogram_add: unsupported device {state.device}")
    lib = _build.library()
    err = lib.theia_histogram_add(
        value.data_ptr(), time.data_ptr(), mask.data_ptr(),
        object_id.data_ptr() if n_detectors is not None else None,
        t0.data_ptr(), bin_size.data_ptr(), value.shape[0], n_bins,
        n_detectors or 0, state.data_ptr(), _build.stream_handle(state.device),
    )
    _build.check(err, "histogram_add")
    histogram_add.launches += 1
    return state


histogram_add.launches = 0


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
