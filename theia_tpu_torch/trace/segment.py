"""The flagship's forward segment as four kernels: the staged route.

``theia_tpu`` runs a segment of ``SceneForwardTracer`` as one XLA program
(``_segment_body``, theia_tpu/trace/scene.py:462, fused under the
``jax.jit`` of ``_trace_batch``); the port's eager ``_segment`` runs the
same body as some 1,250 separate torch launches. Here it is four
hand-written CUDA kernels (``csrc/segment.cu``), with the port's
existing kernels between them as their own launches:

* ``segment_pre`` (K_pre): the health check, the distance draw and
  ``sample_scatter_length``, the guide's ``eval``, the free-extension
  test and the query's ``t_max``;
* the nearest-hit scan, without rows (``nearest_in_table`` on brute-force
  packs, ``nearest_triangle_mt`` on ``mt`` packs);
* ``segment_surface`` (K_surface): the hit rebuilt from ``tri_data`` and
  ``inst_data`` by the winner's index, the extension and its propagation
  to the hit, ``propagate_ray`` and ``update_ray_is``, the Fresnel surface
  with its draw, the new medium and its constants, the fused record's
  item, and the result codes, ``alive`` and ``allow_response`` (none of
  which depends on the scatter);
* the record (``histogram_add``);
* ``segment_scatter`` (K_scatter, segments before the last): the MIS
  draws, the phase and guide samples, the two weights and the 2N shadow
  rays, then the real ray's phase scatter;
* the shadow query (``target_in_table``, or the full nearest hit on ``mt``
  packs);
* ``segment_shadow`` (K_shadow): the 2N target hits rebuilt and
  ``_shadow_item``'s item;
* the record.

Each wrapper runs its plain twin (``*_plain``) on CPU tensors and launches
its kernel on CUDA tensors, or raises: there is no fallback. The twins
take and return the same flat per-lane tensors as the kernels and are
composed from the eager segment's own helpers in its op order, so that on
the CPU the staged route equals the eager one bit for bit; the kernels
repeat the twins' float32 ops in the same order (``-fmad=false``, IEEE
division and square root, the libdevice functions that torch's CUDA ops
call), so on the card they equal the twins, and the staged route the eager
one, bit for bit. The kernels are forward-only: a batch that keeps
autograd on takes the eager segment, which is the staged route's autograd
path.

Which batches take the route: :func:`route` (``SceneForwardTracer.
segment_route``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields, replace

import torch

from .. import _build, accel, response as _response
from ..accel import _reconstruct_hit
from ..callback import EmptyEventCallback
from ..material import _CONST4_KINDS, _CONST4_NULLS, MediumConstants
from ..ops.table_read import PHASE, _Spec, packed_spec
from ..random import PhiloxRNG, RNGState
from ..response import HistogramHitResponse, UniformValueResponse
from ..target import SphereTargetGuide
from .core import (
    EventResultCode,
    RayState,
    merge_dim,
    propagate_ray,
    reattach_geometry,
    sample_scatter_length,
    select_ray,
    update_ray_is,
)

__all__ = [
    "Lanes",
    "route",
    "trace_stages",
    "segment_pre",
    "segment_pre_plain",
    "segment_surface",
    "segment_surface_plain",
    "segment_scatter",
    "segment_scatter_plain",
    "segment_shadow",
    "segment_shadow_plain",
]


def route(tracer) -> str:
    """``"stages"`` where a batch of ``tracer`` takes the four kernels,
    else ``"eager"``: autograd is off (``run()``, ``Pipeline.launch``, ``ShardedRunner``'s
    forward), the tracer is neither polarized nor in photon mode and keeps
    the forward's surface rules, the guide is a ``SphereTargetGuide``, the
    response a ``HistogramHitResponse`` of a ``UniformValueResponse`` (so
    the responses fuse), the callback an ``EmptyEventCallback``, the
    generator a ``PhiloxRNG``, and the scene a brute-force or ``mt`` pack."""
    from . import scene

    pack = tracer.scene.pack
    ok = (
        not torch.is_grad_enabled()
        and not tracer.polarized
        and not tracer._photon_mode
        and (tracer._target_bit, tracer._no_r_bit, tracer._no_t_bit, tracer._transmit_eta2)
        == (scene._DETECTOR, scene._NO_R_FWD, scene._NO_T_FWD, False)
        and type(tracer.targetGuide) is SphereTargetGuide
        and type(tracer.response) is HistogramHitResponse
        and type(tracer.response.value_response) is UniformValueResponse
        and type(tracer.callback) is EmptyEventCallback
        and type(tracer.rng) is PhiloxRNG
        and (pack.soup is not None or pack.mt is not None)
    )
    return "stages" if ok else "eager"


# ---------------------------------------------------------------------------
# the per-lane tensors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Lanes:
    """A segment's per-lane state: the ray (``position`` and ``direction``
    f32 (N, 3), the rest f32 (N,)), its medium (i32), ``alive`` and
    ``allow`` (``allow_response``, bool) and its RNG cursor (``stream``,
    ``dim``, i32)."""

    position: torch.Tensor
    direction: torch.Tensor
    wavelength: torch.Tensor
    time: torch.Tensor
    lin: torch.Tensor
    log: torch.Tensor
    n: torch.Tensor
    vg: torch.Tensor
    mu_s: torch.Tensor
    mu_e: torch.Tensor
    medium: torch.Tensor
    alive: torch.Tensor
    allow: torch.Tensor
    stream: torch.Tensor
    dim: torch.Tensor

    @staticmethod
    def of(ray: RayState, medium, alive, allow, rng: RNGState) -> "Lanes":
        """The lanes of a batch's initial rays, contiguous (a copy only of
        what is not: the kernels read each array at its lane)."""
        c = ray.constants
        return Lanes(*(t.contiguous() for t in (
            ray.position, ray.direction, ray.wavelength, ray.time, ray.lin_contrib, ray.log_contrib,
            c.n, c.vg, c.mu_s, c.mu_e, medium, alive, allow, rng.stream, rng.dim,
        )))

    def ray(self) -> RayState:
        return RayState(
            position=self.position, direction=self.direction, wavelength=self.wavelength, time=self.time,
            lin_contrib=self.lin, log_contrib=self.log,
            constants=MediumConstants(n=self.n, vg=self.vg, mu_s=self.mu_s, mu_e=self.mu_e),
        )

    def with_ray(self, ray: RayState, **kw) -> "Lanes":
        c = ray.constants
        return replace(self, position=ray.position, direction=ray.direction, time=ray.time, lin=ray.lin_contrib,
                       log=ray.log_contrib, n=c.n, vg=c.vg, mu_s=c.mu_s, mu_e=c.mu_e, **kw)


@dataclass(frozen=True)
class Pre:
    """K_pre's outputs: ``alive`` after the health check, the query's
    ``t_max``, the sampled distance, the free-extension mask and the dim
    after the distance draw."""

    alive: torch.Tensor
    t_max: torch.Tensor
    sampled: torch.Tensor
    mis_ext: torch.Tensor
    dim: torch.Tensor


@dataclass(frozen=True)
class Item:
    """A record's per-lane item: the value (the contribution), the time,
    the mask and the detector id (for a histogram with a detector axis)."""

    value: torch.Tensor
    time: torch.Tensor
    mask: torch.Tensor
    object_id: torch.Tensor | None


@dataclass(frozen=True)
class Shadow:
    """The 2N MIS shadow rays of K_scatter (the phase sample's N, then the
    guide sample's N): their query (origin, direction, ``t_max``, medium,
    ``active``) and their contribution (``lin``, ``log``)."""

    origin: torch.Tensor
    direction: torch.Tensor
    t_max: torch.Tensor
    lin: torch.Tensor
    log: torch.Tensor
    medium: torch.Tensor
    active: torch.Tensor


class Setup:
    """What a batch's kernels share: the tracer, its parameters and
    propagation bounds, the generator's words and, on the card, the
    kernels' constants (``TheiaSegmentConst``: the four packed reads'
    specs, the scene's rows, the parameters' device pointers), built once
    a batch with no host read of a device value."""

    def __init__(self, tracer, p, prop, counter) -> None:
        self.tracer, self.p, self.prop = tracer, p, prop
        self.pack = p["scene"]
        self.key = tracer.rng.key_words
        self.counter = tuple(int(c) for c in counter)
        self.n_detectors = tracer.response.nDetectors
        self.const = None
        if self.pack.tri_data.device.type == "cuda":
            self.const = _const(self)

    def rng(self, stream, dim) -> RNGState:
        return RNGState(key=self.key, counter=self.counter, stream=stream, dim=dim)


# ---------------------------------------------------------------------------
# the plain twins: the eager segment's helpers in its op order
# ---------------------------------------------------------------------------


def segment_pre_plain(s: Setup, lanes: Lanes) -> Pre:
    """K_pre's plain twin: ``_segment``'s health check, distance draw and
    free-extension test (theia_tpu/trace/scene.py:483-498)."""
    ray = lanes.ray()
    alive = lanes.alive & ~ray.is_bad()
    uu, rng = s.rng(lanes.stream, lanes.dim).uniform()
    dist = sample_scatter_length(ray, s.prop, uu)
    guide_eval = s.tracer.targetGuide.eval(s.p["guide"], ray.position, ray.direction)
    mis_ext = lanes.allow & (guide_eval.prob > 0.0) & (guide_eval.dist > dist)
    t_max = torch.where(mis_ext, torch.maximum(guide_eval.dist, dist), dist)
    return Pre(alive, t_max, dist, mis_ext, rng.dim)


def segment_surface_plain(s: Setup, lanes: Lanes, pre: Pre, t_hit, tri):
    """K_surface's plain twin: ``_segment`` from the hit's reconstruction
    to the new medium's constants, fused and unpolarized, and the result
    codes (theia_tpu/trace/scene.py:500-750, 904-935), which need no scatter state,
    so the last segment's is the same call. Returns (lanes, ``miss``, the
    record's item)."""
    tracer, pack, prop = s.tracer, s.pack, s.prop
    ray, medium, pre_alive = lanes.ray(), lanes.medium, pre.alive
    hit = _reconstruct_hit(pack, medium, ray.position, ray.direction, t_hit, tri)
    travel = torch.where(hit.valid, hit.t, pre.t_max)
    ext_mask = pre_alive & pre.mis_ext & hit.valid & (travel > pre.sampled) & (hit.error == 0)
    ext_ray, ext_code = tracer._propagate_to_hit(ray, hit, prop)
    ext_ok = ext_mask & (ext_code >= 0)
    hit = replace(hit, valid=hit.valid & ~ext_mask)
    travel = torch.where(ext_mask, pre.sampled, travel)

    ray, code = propagate_ray(ray, travel, prop)
    ray = reattach_geometry(ray, travel, valid=hit.valid)
    ray = update_ray_is(ray, travel, prop, hit.valid)
    code = torch.where(hit.valid & (hit.error != 0), hit.error, code)
    in_bounds = code >= 0

    surf = pre_alive & in_bounds & hit.valid
    ray = replace(ray, position=torch.where(surf[..., None], hit.world_pos, ray.position))
    n_i, n_t, r_s, r_p = _scene._fresnel(pack, ray, hit)
    kinds = tracer._surface_kinds(hit.flags, surf)
    is_abs, is_target, vol_border = kinds[:3]
    target_id = s.p["tracer"]["targetId"]
    correct = (target_id < 0) | (hit.custom_id == target_id)
    respond = surf & lanes.allow & is_target & correct
    resp_ray = select_ray(ext_ok, ext_ray, ray)
    rec_mask = respond | (ext_ok & is_target & correct)
    item, pos_ok = tracer._create_response_item(resp_ray, hit, r_s, r_p, n_i, n_t, is_abs)
    record = Item(item.contrib, item.time, rec_mask & pos_ok, hit.custom_id if s.n_detectors is not None else None)

    ray, new_medium, rng, _, _, _, absorbed_surf = tracer._surface_outcome(
        pack, ray, medium, hit, surf, kinds, r_s, r_p, n_i, n_t, s.rng(lanes.stream, pre.dim)
    )
    code, alive = _scene._result_codes(code, pre_alive, in_bounds, surf, respond, vol_border, absorbed_surf)
    miss = pre_alive & in_bounds & ~hit.valid
    allow = code != int(EventResultCode.RAY_SCATTERED)
    out = lanes.with_ray(ray, medium=new_medium, alive=alive, allow=allow, dim=rng.dim)
    return out, miss, record


def segment_scatter_plain(s: Setup, lanes: Lanes, miss):
    """K_scatter's plain twin: ``_mis_shadow``'s draws, samples and
    weights and its 2N shadow rays (fused), then ``_segment``'s phase
    scatter of the real ray (theia_tpu/trace/scene.py:751-902).
    Returns (lanes, the shadow rays)."""
    tracer, pack = s.tracer, s.pack
    ray, medium = lanes.ray(), lanes.medium
    rng_b = rng = s.rng(lanes.stream, lanes.dim)
    dir_phase, guide_sample, phase_eval, w_phase, w_target, log_p_pp, log_p_pt, rng = tracer._mis_samples(
        s.p, pack, ray, medium, rng
    )
    lin_p, log_p = _scene._mis_contrib(ray, w_phase, log_p_pp)
    lin_t, log_t = _scene._mis_contrib(ray, w_target, log_p_pt)
    tile = lambda a: torch.cat([a, a])
    shadow = Shadow(
        origin=tile(ray.position),
        direction=torch.cat([dir_phase, guide_sample.direction]),
        t_max=torch.cat([phase_eval.dist, guide_sample.dist]),
        lin=torch.cat([lin_p, lin_t]),
        log=torch.cat([log_p, log_t]),
        medium=tile(medium),
        active=tile(miss),
    )
    rng = merge_dim(rng, rng_b, miss)
    ray, _, rng = tracer._scatter_real(pack, ray, medium, miss, rng)
    out = replace(lanes, direction=ray.direction, lin=ray.lin_contrib, log=ray.log_contrib, dim=rng.dim)
    return out, shadow


def segment_shadow_plain(s: Setup, lanes: Lanes, shadow: Shadow, t_hit, tri) -> Item:
    """K_shadow's plain twin: the 2N target hits rebuilt and
    ``_shadow_item``'s item of the fused record (theia_tpu/trace/scene.py:
    390-407, 793-870)."""
    tile = lambda a: torch.cat([a, a])
    shadow2 = RayState(
        position=shadow.origin, direction=shadow.direction, wavelength=tile(lanes.wavelength),
        time=tile(lanes.time), lin_contrib=shadow.lin, log_contrib=shadow.log,
        constants=MediumConstants(n=tile(lanes.n), vg=tile(lanes.vg), mu_s=tile(lanes.mu_s), mu_e=tile(lanes.mu_e)),
    )
    hit2 = _reconstruct_hit(s.pack, shadow.medium, shadow.origin, shadow.direction, t_hit, tri)
    item2, ok2 = s.tracer._shadow_item(s.p, shadow2, hit2, shadow.active, s.prop)
    return Item(item2.contrib, item2.time, ok2, hit2.custom_id if s.n_detectors is not None else None)


# ---------------------------------------------------------------------------
# the kernels' C interface (csrc/segment.cu)
# ---------------------------------------------------------------------------


class _Const(ctypes.Structure):
    """TheiaSegmentConst of ``csrc/segment.cu``, field for field."""

    _fields_ = [
        ("ior", _Spec),
        ("constants", _Spec),
        ("sampling", _Spec),
        ("log_phase", _Spec),
        ("sampling_sizes", ctypes.c_void_p),
        ("tri_data", ctypes.c_void_p),
        ("inst_data", ctypes.c_void_p),
        ("guide_position", ctypes.c_void_p),
        ("guide_radius", ctypes.c_void_p),
        ("scatter_coef", ctypes.c_void_p),
        ("max_time", ctypes.c_void_p),
        ("max_dist", ctypes.c_void_p),
        ("lower", ctypes.c_void_p),
        ("upper", ctypes.c_void_p),
        ("target_id", ctypes.c_void_p),
        ("key", ctypes.c_uint32 * 2),
        ("counter", ctypes.c_uint32 * 4),
        ("volume_border", ctypes.c_int),
        ("transmission", ctypes.c_int),
    ]


#: TheiaSegmentLanes of ``csrc/segment.cu``, field for field: every
#: per-lane array a kernel reads or writes (null where it takes none)
_LANE_FIELDS = (
    "position", "direction", "wavelength", "time", "lin", "log", "n", "vg", "mu_s", "mu_e",
    "medium", "alive", "allow", "stream", "dim",
    "pre_alive", "t_max", "sampled", "mis_ext", "pre_dim",
    "t_hit", "tri",
    "out_position", "out_direction", "out_time", "out_lin", "out_log",
    "out_n", "out_vg", "out_mu_s", "out_mu_e", "out_medium", "out_alive", "out_allow", "out_dim", "miss",
    "value", "item_time", "mask", "object_id",
    "shadow_origin", "shadow_direction", "shadow_t_max", "shadow_lin", "shadow_log", "shadow_medium",
    "shadow_active",
)


class _LanePointers(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _LANE_FIELDS] + [("count", ctypes.c_int)]


def _f32(t: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.to(torch.float32).contiguous()


def _const(s: Setup) -> _Const:
    """The kernels' constants of one batch (kept on ``s`` so the tensors
    they point to live as long as it)."""
    media, tracer = s.pack.media, s.tracer
    tables = lambda kinds: tuple(media.tables[k] for k in kinds)
    sizes = lambda kinds: tuple(media.sizes[k] for k in kinds)
    device = s.pack.tri_data.device
    s.keep = keep = [
        _f32(s.p["guide"]["position"]), _f32(s.p["guide"]["radius"]), _f32(s.prop.scatter_coefficient),
        _f32(s.prop.max_time), _f32(s.prop.max_dist), _f32(s.prop.lower_bbox), _f32(s.prop.upper_bbox),
        torch.as_tensor(s.p["tracer"]["targetId"]).to(torch.int32).contiguous(),
    ]
    if any(t.device != device for t in keep):
        raise ValueError(f"segment kernels: every parameter must be on {device}")
    bounds = (media.lambda_min, media.lambda_max)
    c = _Const(
        ior=packed_spec(media.tables["refractive_index"], media.sizes["refractive_index"], 1.0, bounds=bounds,
                        clips=2, device=device),
        constants=packed_spec(tables(_CONST4_KINDS), sizes(_CONST4_KINDS), _CONST4_NULLS, bounds=bounds,
                              clips=1 if media.const4_ok else 2, shared=media.const4_ok, device=device),
        sampling=packed_spec(media.tables["phase_sampling"], media.sizes["phase_sampling"], 0.0, device=device),
        log_phase=packed_spec(media.tables["log_phase_function"], media.sizes["log_phase_function"],
                              _scene._LOG_INV_4PI, affine=PHASE, device=device),
        sampling_sizes=media.sizes["phase_sampling"].data_ptr(),
        tri_data=s.pack.tri_data.data_ptr(),
        inst_data=s.pack.inst_data.data_ptr(),
        key=(ctypes.c_uint32 * 2)(*s.key),
        counter=(ctypes.c_uint32 * 4)(*(w & 0xFFFFFFFF for w in s.counter)),
        volume_border=int(not tracer.disableVolumeBorder),
        transmission=int(not tracer.disableTransmission),
    )
    for name, t in zip(("guide_position", "guide_radius", "scatter_coef", "max_time", "max_dist", "lower", "upper",
                        "target_id"), keep):
        setattr(c, name, t.data_ptr())
    for t in (s.pack.tri_data, s.pack.inst_data):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 32 or not t.is_contiguous():
            raise ValueError("segment kernels: tri_data and inst_data are contiguous f32 (rows, 32)")
    return c


def _launch(fn, name: str, s: Setup, count: int, **arrays) -> None:
    """Launch the entry point ``name`` over ``count`` lanes with the lane
    arrays ``arrays`` (tensors by field name of ``_LANE_FIELDS``)."""
    lanes = _LanePointers(count=count)
    for key, t in arrays.items():
        if t is not None:
            setattr(lanes, key, t.data_ptr())
    if count:
        lib = _build.library()
        _build.check(getattr(lib, name)(ctypes.byref(s.const), ctypes.byref(lanes), _build.raw_stream(s.pack.tri_data)),
                     name)
        fn.launches += 1


def _state_arrays(lanes: Lanes) -> dict:
    return {f.name: getattr(lanes, f.name) for f in fields(lanes)}


def _on_card(s: Setup, *tensors) -> bool:
    """True for CUDA tensors (the kernel), False for CPU ones (the twin);
    anything else, or a mix, raises."""
    dev = s.pack.tri_data.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"segment kernels: every tensor must be on {dev}, got {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"segment kernels: unsupported device {dev}")
    return dev.type == "cuda"


def _check_lanes(lanes: Lanes) -> None:
    n = lanes.wavelength.shape[0]
    for f in fields(lanes):
        t = getattr(lanes, f.name)
        want = {"medium": torch.int32, "stream": torch.int32, "dim": torch.int32, "alive": torch.bool,
                "allow": torch.bool}.get(f.name, torch.float32)
        shape = (n, 3) if f.name in ("position", "direction") else (n,)
        if t.dtype != want or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"segment kernels: {f.name} must be a contiguous {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _empty(like: torch.Tensor, dtype=None, shape=None) -> torch.Tensor:
    return torch.empty(like.shape if shape is None else shape, dtype=like.dtype if dtype is None else dtype,
                       device=like.device)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def segment_pre(s: Setup, lanes: Lanes) -> Pre:
    """K_pre (``theia_segment_pre``); the plain twin on the CPU."""
    _check_lanes(lanes)
    if not _on_card(s, lanes.position):
        return segment_pre_plain(s, lanes)
    w = lanes.wavelength
    out = Pre(_empty(lanes.alive), _empty(w), _empty(w), _empty(lanes.alive), _empty(lanes.dim))
    _launch(segment_pre, "theia_segment_pre", s, w.shape[0], **_state_arrays(lanes), pre_alive=out.alive,
            t_max=out.t_max, sampled=out.sampled, mis_ext=out.mis_ext, pre_dim=out.dim)
    return out


def segment_surface(s: Setup, lanes: Lanes, pre: Pre, t_hit, tri):
    """K_surface (``theia_segment_surface``); the plain twin on the CPU.
    Returns (lanes, ``miss``, the record's item)."""
    _check_lanes(lanes)
    if t_hit.dtype != torch.float32 or tri.dtype != torch.int32 or not t_hit.shape == tri.shape == lanes.dim.shape:
        raise ValueError("segment_surface: t_hit f32 (N,) and tri i32 (N,)")
    if not _on_card(s, lanes.position, t_hit, tri):
        return segment_surface_plain(s, lanes, pre, t_hit, tri)
    w = lanes.wavelength
    out = replace(
        lanes, position=_empty(lanes.position), direction=_empty(lanes.direction), time=_empty(w), lin=_empty(w),
        log=_empty(w), n=_empty(w), vg=_empty(w), mu_s=_empty(w), mu_e=_empty(w), medium=_empty(lanes.medium),
        alive=_empty(lanes.alive), allow=_empty(lanes.allow), dim=_empty(lanes.dim),
    )
    miss = _empty(lanes.alive)
    item = Item(_empty(w), _empty(w), _empty(lanes.alive), _empty(lanes.medium) if s.n_detectors is not None else None)
    _launch(
        segment_surface, "theia_segment_surface", s, w.shape[0], **_state_arrays(lanes),
        pre_alive=pre.alive, t_max=pre.t_max, sampled=pre.sampled, mis_ext=pre.mis_ext, pre_dim=pre.dim,
        t_hit=t_hit.contiguous(), tri=tri.contiguous(),
        out_position=out.position, out_direction=out.direction, out_time=out.time, out_lin=out.lin,
        out_log=out.log, out_n=out.n, out_vg=out.vg, out_mu_s=out.mu_s, out_mu_e=out.mu_e,
        out_medium=out.medium, out_alive=out.alive, out_allow=out.allow, out_dim=out.dim, miss=miss,
        value=item.value, item_time=item.time, mask=item.mask, object_id=item.object_id,
    )
    return out, miss, item


def segment_scatter(s: Setup, lanes: Lanes, miss):
    """K_scatter (``theia_segment_scatter``); the plain twin on the CPU.
    Returns (lanes, the 2N shadow rays)."""
    _check_lanes(lanes)
    if not _on_card(s, lanes.position, miss):
        return segment_scatter_plain(s, lanes, miss)
    w = lanes.wavelength
    n = w.shape[0]
    out = replace(lanes, direction=_empty(lanes.direction), lin=_empty(w), log=_empty(w), dim=_empty(lanes.dim))
    shadow = Shadow(
        _empty(lanes.position, shape=(2 * n, 3)), _empty(lanes.direction, shape=(2 * n, 3)),
        _empty(w, shape=(2 * n,)), _empty(w, shape=(2 * n,)), _empty(w, shape=(2 * n,)),
        _empty(lanes.medium, shape=(2 * n,)), _empty(miss, shape=(2 * n,)),
    )
    _launch(
        segment_scatter, "theia_segment_scatter", s, n, **_state_arrays(lanes), miss=miss.contiguous(),
        out_direction=out.direction, out_lin=out.lin, out_log=out.log, out_dim=out.dim,
        shadow_origin=shadow.origin, shadow_direction=shadow.direction, shadow_t_max=shadow.t_max,
        shadow_lin=shadow.lin, shadow_log=shadow.log, shadow_medium=shadow.medium, shadow_active=shadow.active,
    )
    return out, shadow


def segment_shadow(s: Setup, lanes: Lanes, shadow: Shadow, t_hit, tri) -> Item:
    """K_shadow (``theia_segment_shadow``) over the 2N shadow rays; the
    plain twin on the CPU."""
    _check_lanes(lanes)
    if not _on_card(s, lanes.position, shadow.origin, t_hit, tri):
        return segment_shadow_plain(s, lanes, shadow, t_hit, tri)
    w = shadow.t_max
    item = Item(_empty(w), _empty(w), _empty(shadow.active), _empty(shadow.medium) if s.n_detectors is not None else None)
    # the launch's count is the shadow rays' 2N; the per-lane state is read at i mod N
    _launch(
        segment_shadow, "theia_segment_shadow", s, w.shape[0], **_state_arrays(lanes),
        t_hit=t_hit.contiguous(), tri=tri.contiguous(),
        shadow_origin=shadow.origin, shadow_direction=shadow.direction, shadow_t_max=shadow.t_max,
        shadow_lin=shadow.lin, shadow_log=shadow.log, shadow_medium=shadow.medium, shadow_active=shadow.active,
        value=item.value, item_time=item.time, mask=item.mask, object_id=item.object_id,
    )
    return item


for _fn in (segment_pre, segment_surface, segment_scatter, segment_shadow):
    _fn.launches = 0
del _fn


# ---------------------------------------------------------------------------
# the staged route
# ---------------------------------------------------------------------------


def _nearest(pack, origin, direction, t_max):
    """The primary query without rows: the winner's index alone, which
    K_surface reads ``tri_data`` and ``inst_data`` by."""
    if pack.mt is not None:
        return accel.nearest_triangle_mt(pack.mt, origin, direction, t_max)
    return accel.nearest_in_table(pack.soup, origin, direction, t_max)


def _target(pack, origin, direction, t_max, active):
    """The MIS shadow query without rows: ``accel.intersect_target``'s
    split on a brute-force pack with a detector, else the full nearest
    hit (which reads no ``active``)."""
    if pack.soup is None or not any(pack.soup_is_det):
        return _nearest(pack, origin, direction, t_max)
    return accel.target_in_table(
        pack.soup, origin, direction, t_max, active=active,
        groups=[k for k, d in enumerate(pack.soup_is_det) if d],
        occluders=[k for k, d in enumerate(pack.soup_is_det) if not d],
    )


def _record(s: Setup, state, item: Item):
    """The histogram record of an item: what ``HistogramHitResponse.record``
    does with a ``UniformValueResponse``'s value."""
    params = s.p["response"]
    return _response.histogram_add(
        state, item.value, item.time, item.mask, params["t0"], params["binSize"], s.tracer.response.nBins,
        item.object_id if s.n_detectors is not None else None, s.n_detectors,
    )


def trace_stages(tracer, p, counter, streams):
    """``SceneForwardTracer._trace_batch`` on the staged route: the initial
    rays as the eager route samples them, then each segment as K_pre,
    the scan, K_surface and the record, and on every segment but the last
    K_scatter, the shadow query, K_shadow and the record."""
    pack = p["scene"]
    prop = tracer._propagation(p)
    rng = tracer.rng.state_for(counter, streams)
    ray, medium, alive, allow, _, rng = tracer._initial_carry(p, pack, streams, rng)
    s = Setup(tracer, p, prop, counter)
    lanes = Lanes.of(ray, medium, alive, allow, rng)
    resp_state = tracer.response.init(streams.device)
    # an EmptyEventCallback's events change nothing: its state is init's
    cb_state = tracer.callback.init(streams.shape[0], tracer.maxPathLength + 2, streams.device)
    for i in range(tracer.maxPathLength):
        last = i == tracer.maxPathLength - 1
        pre = segment_pre(s, lanes)
        t_hit, tri = _nearest(pack, lanes.position, lanes.direction, pre.t_max)
        lanes, miss, item = segment_surface(s, lanes, pre, t_hit, tri)
        resp_state = _record(s, resp_state, item)
        if not last:
            lanes, shadow = segment_scatter(s, lanes, miss)
            t2, tri2 = _target(pack, shadow.origin, shadow.direction, shadow.t_max, shadow.active)
            resp_state = _record(s, resp_state, segment_shadow(s, lanes, shadow, t2, tri2))
        if tracer._debug_segments is not None:
            tracer._debug_segments.append(snapshot(lanes.ray(), lanes.medium, lanes.alive, lanes.allow, lanes.dim))
    if tracer._debug_rng:
        return resp_state, cb_state, lanes.dim
    return resp_state, cb_state


def snapshot(ray: RayState, medium, alive, allow, dim) -> dict:
    """A copy of a segment's end state, by name: what the conformance hook
    ``_debug_segments`` collects on either route."""
    c = ray.constants
    state = dict(position=ray.position, direction=ray.direction, wavelength=ray.wavelength, time=ray.time,
                 lin=ray.lin_contrib, log=ray.log_contrib, n=c.n, vg=c.vg, mu_s=c.mu_s, mu_e=c.mu_e, medium=medium,
                 alive=alive, allow=allow, dim=dim)
    return {k: v.detach().clone() for k, v in state.items()}


from . import scene as _scene  # noqa: E402  (trace.scene imports this module lazily, in _trace_batch)
