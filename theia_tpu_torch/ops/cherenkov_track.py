"""The backward sample of a Cherenkov track: one emission candidate a
segment, one picked in proportion to its contribution.

For an observer, each straight segment of a ``ParticleTrack`` has at most
one point whose Cherenkov cone passes through it; its contribution is
``ft cos / d_perp`` (zero off the segment or behind the observer's
surface). The lane carries the sum over the segments and one candidate
drawn with probability proportional to its share: ``k = #(cum < u
total)``, capped at S - 1 (``theia_tpu.light.CherenkovTrackLightSource.
sample_backward``, theia_tpu/light.py:654, which builds (N, S, 3) tensors,
a ``cumsum`` and a ``take_along_axis``).

:func:`track_backward_sample` launches the kernel of
``csrc/cherenkov_track.cu`` on CUDA tensors (a thread a lane, one pass
over the segments in the short form of a pair, listing the segments on
the segment, then the listed pairs whole; a lane that is not tame or
lists more than ``TRACK_LIST`` takes two full passes) and runs
:func:`track_backward_sample_plain` on CPU tensors: a loop over the
segments of (N,) tensors, never an (N, S) one. Both sum the candidates in
segment order, which differs from JAX's association (its ``sum`` and
``cumsum`` over the segment axis): the total agrees with ``theia_tpu`` to
rounding and k on every lane whose ``cum`` does not lie within a few ulp
of ``u total``. The outputs are differentiable in the segment table and in
the lanes' observer, normal, Frank-Tamm factor and cotangent; k is not. On
the card the gradient recomputes the total and the chosen candidate by
the plain loop under autograd, so the forward stays the kernel.

The kernel's shortcut rests on one fact: off the segment, a tame lane's
pair contributes a zero (``ft cos / d_perp`` is finite there), and a zero
leaves the running sum's bits as they were. A row is tame where its start
lies within ``TAME_POSITION`` and its direction within
``TAME_DIRECTION`` in each coordinate; a lane where its observer lies
within ``TAME_POSITION``, ``|cot| <= TAME_COT``, and ``|ft|``, the L1 norm
of its normal and the product of the two, each floored at 1, are at most
``TAME_WEIGHT``. ``tests/test_torch_track_sample_rule.py`` mirrors the
rule on the CPU and holds the constants equal to the kernel's.
"""

from __future__ import annotations

import torch

from .. import _build
from .math3d import dot, norm, normalize, sqrt, vec3

__all__ = ["segment_table", "track_backward_sample", "track_backward_sample_plain", "SEGMENT_COLUMNS"]

#: columns of a segment's row: start x, y, z, start and end time, unit
#: direction x, y, z, length
SEGMENT_COLUMNS = 9
#: the kernel's list of a lane's segments on the segment (kList)
TRACK_LIST = 16
#: the bounds of a tame row and lane (kTamePosition, kTameDirection,
#: kTameCot, kTameWeight): within them every intermediate of a pair's full
#: form is finite, so ft cos / d_perp is, and a pair off the segment adds a zero
TAME_POSITION, TAME_DIRECTION, TAME_COT, TAME_WEIGHT = 1e15, 2.0, 1e7, 1e20


def segment_table(track: torch.Tensor) -> torch.Tensor:
    """(S, 9) rows of a (L, 4) [x, y, z, t] vertex array's segments, as
    ``theia_tpu`` forms them: the vector, its length ``sqrt(max(|v|^2,
    1e-30))`` and the unit direction."""
    v0, v1 = track[:-1], track[1:]
    seg_vec = v1[:, :3] - v0[:, :3]
    seg_len = sqrt(torch.clamp_min(dot(seg_vec, seg_vec), 1e-30))
    seg_dir = seg_vec / seg_len[:, None]
    return torch.cat([v0[:, :4], v1[:, 3:4], seg_dir, seg_len[:, None]], dim=1).contiguous()


def _candidate(seg, observer, cot):
    """One segment's candidate for every lane: (direction, position, time,
    d_perp, mu, length); ``seg`` one row (9,) or a row a lane (N, 9)."""
    col = lambda j: seg[..., j]
    v0, seg_dir = vec3(col(0), col(1), col(2)), vec3(col(5), col(6), col(7))
    mu = dot(observer - v0, seg_dir)
    d_perp = norm(observer - (v0 + mu[..., None] * seg_dir))
    mu = mu - cot * d_perp
    position = v0 + mu[..., None] * seg_dir
    frac = mu / col(8)
    time = col(3) * (1.0 - frac) + col(4) * frac
    return normalize(observer - position), position, time, d_perp, mu, col(8)


def _contrib(cand, normal, is_zero, ft):
    ray_dir, _, _, d_perp, mu, seg_len = cand
    cos_nrm = torch.clamp_min(torch.where(is_zero, 1.0, dot(ray_dir, normal)), 0.0)
    on_seg = (mu >= 0.0) & (mu <= seg_len)
    return ft * cos_nrm / d_perp * on_seg.to(torch.float32)


def _total_plain(seg, observer, normal, ft, cot):
    is_zero = dot(normal, normal) == 0.0
    total = torch.zeros_like(ft)
    for s in range(seg.shape[0]):
        total = total + _contrib(_candidate(seg[s], observer, cot), normal, is_zero, ft)
    return total, is_zero


def _chosen(seg, k, observer, cot):
    ray_dir, position, time, *_ = _candidate(seg[k], observer, cot)
    return position, ray_dir, time


def track_backward_sample_plain(seg, observer, normal, ft, cot, u):
    """Plain PyTorch version of :func:`track_backward_sample` (any
    device; differentiable under autograd)."""
    total, is_zero = _total_plain(seg, observer, normal, ft, cot)
    with torch.no_grad():
        thresh = u * total
        cum = torch.zeros_like(ft)
        k = torch.zeros(ft.shape, dtype=torch.int32, device=ft.device)
        for s in range(seg.shape[0]):
            cum = cum + _contrib(_candidate(seg[s], observer, cot), normal, is_zero, ft)
            k = k + (cum < thresh).to(torch.int32)
        k = torch.clamp_max(k, seg.shape[0] - 1)
    return (total, *_chosen(seg, k, observer, cot), k)


def _check(seg, observer, normal, ft, cot, u) -> None:
    if seg.dim() != 2 or seg.shape[1] != SEGMENT_COLUMNS or seg.shape[0] < 1:
        raise ValueError(f"seg must be (S >= 1, {SEGMENT_COLUMNS}), got {tuple(seg.shape)}")
    n = observer.shape[0]
    for name, t, shape in (("observer", observer, (n, 3)), ("normal", normal, (n, 3)), ("ft", ft, (n,)),
                           ("cot", cot, (n,)), ("u", u, (n,)), ("seg", seg, tuple(seg.shape))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != observer.device:
            raise ValueError(f"{name} must be float32 {shape} on the observers' device")


def _launch(seg, observer, normal, ft, cot, u):
    n = observer.shape[0]
    total, time = torch.empty_like(ft), torch.empty_like(ft)
    k = torch.empty(n, dtype=torch.int32, device=ft.device)
    position, direction = torch.empty_like(observer), torch.empty_like(observer)
    args = [t.contiguous() for t in (seg, observer, normal, ft, cot, u)]
    err = _build.library().theia_track_sample(
        args[0].data_ptr(), seg.shape[0], *(t.data_ptr() for t in args[1:]), n,
        *(t.data_ptr() for t in (total, k, position, direction, time)), _build.stream_handle(ft.device),
    )
    _build.check(err, "track_backward_sample")
    track_backward_sample.launches += 1
    return total, position, direction, time, k


class _TrackSample(torch.autograd.Function):
    """The kernel forward; the backward recomputes the total and the chosen
    candidate through the plain loop under autograd."""

    @staticmethod
    def forward(ctx, seg, observer, normal, ft, cot, u):
        out = _launch(seg, observer, normal, ft, cot, u)
        ctx.save_for_backward(seg, observer, normal, ft, cot, out[4])
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    def backward(ctx, g_total, g_position, g_direction, g_time, _):
        saved = ctx.saved_tensors
        k = saved[-1]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved[:-1], ctx.needs_input_grad)]
        with torch.enable_grad():
            total, _ = _total_plain(*inputs)
            outs = (total, *_chosen(inputs[0], k, inputs[1], inputs[4]))
            # the outputs that depend on an input that wants a gradient, with theirs
            pairs = [(o, torch.zeros_like(o) if g is None else g)
                     for o, g in zip(outs, (g_total, g_position, g_direction, g_time)) if o.requires_grad]
            wanted = [t for t in inputs if t.requires_grad]
            got = [None] * len(wanted)
            if pairs:
                outs, grads = zip(*pairs)
                got = torch.autograd.grad(outs, wanted, grads, allow_unused=True)
            got = iter(got)
        return (*(next(got) if t.requires_grad else None for t in inputs), None)


def track_backward_sample(seg, observer, normal, ft, cot, u):
    """The backward sample of every lane: (total, position, direction,
    time, k) for the (S, 9) segment table ``seg`` (:func:`segment_table`),
    (N, 3) observers and their surface normals (zero for a volume point),
    (N,) Frank-Tamm factors ``ft``, cotangents of the Cherenkov angle
    ``cot`` (cos / max(sin, 1e-7)) and uniforms ``u``. A CUDA tensor
    launches the kernel of ``csrc/cherenkov_track.cu``, a CPU tensor runs
    the plain version."""
    _check(seg, observer, normal, ft, cot, u)
    if observer.device.type == "cpu":
        return track_backward_sample_plain(seg, observer, normal, ft, cot, u)
    if observer.device.type != "cuda":
        raise ValueError(f"track_backward_sample: unsupported device {observer.device}")
    return _TrackSample.apply(seg, observer, normal, ft, cot, u)


track_backward_sample.launches = 0
