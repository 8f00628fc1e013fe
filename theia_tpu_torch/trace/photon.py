"""Photon-resolved tracers: Russian-roulette absorption sampling.

The port of ``theia_tpu.trace.photon``. The reference's wavefront photon
mode traces ``nScatteringPerRun`` segments per "run", compacts the
survivors into a queue and relaunches (reference:
src/theia/trace.py:2370-2959, shader/tracer.{volume,scene}.photon.*.glsl).
:meth:`run` traces ``nRuns x nScatteringPerRun`` masked segments over the
whole wavefront; :meth:`run_compacted` drops dead lanes between runs with
a boolean index, so later runs touch survivors only. Survivors keep their
Philox stream ids and RNG dims, so both give the same draws and the same
histogram up to float32 summation order. ``theia_tpu`` reaches the same
result with a static-shape ladder of halving wavefronts that XLA needs;
the port carries the result, not the ladder.

Per segment a photon's accumulated contribution is its survival chance:
survival is sampled (contrib <= u -> absorbed), then the contribution
resets to 1. A detection reports the survival chance as its
contribution; pair with ``StoreTimeHitResponse`` to sample the final
detection (reference: trace.py:2735-2741).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import units as u
from ..callback import EmptyEventCallback, TraceEventCallback
from ..component import Component, TraceConfig, host_dict, resolve_device
from ..light import LightSource, WavelengthSource
from ..lookup import lookup
from ..material import Medium, medium_constants
from ..ops.math3d import dot, sqrt
from ..ops.sampling import scatter_dir
from ..ops.table_read import PHASE
from ..random import RNG, RNGState
from ..target import Target
from .core import (
    EventResultCode,
    PropagateParams,
    RayState,
    TracerBase,
    active_lanes,
    create_hit,
    merge_dim,
    propagate_ray,
    reattach_geometry,
    sample_scatter_dir_medium,
    sample_scatter_length,
    scatter_ray_is,
    select_ray,
    update_ray_is,
)
from .scene import SceneForwardTracer

__all__ = ["VolumePhotonTracer", "ScenePhotonTracer"]


def _sample_absorption(ray: RayState, alive, rng: RNGState):
    """Russian roulette on the accumulated contribution; survivors reset
    to contribution 1 (reference: tracer.volume.photon.common.glsl:88-104)."""
    uu, rng_after = rng.uniform()
    survive = ray.contrib > uu
    rng = merge_dim(rng_after, rng, alive)
    kept = alive & survive
    ray = replace(
        ray,
        lin_contrib=torch.where(kept, 1.0, ray.lin_contrib),
        log_contrib=torch.where(kept, 0.0, ray.log_contrib),
    )
    return ray, kept, rng


def _take(state, keep: torch.Tensor):
    """``state`` (nested tuples, dicts, ray states and (N, ...) tensors)
    at the lanes where ``keep`` is set."""
    if isinstance(state, torch.Tensor):
        return state[keep]
    if isinstance(state, dict):
        return {k: _take(v, keep) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_take(v, keep) for v in state)
    if state is None:
        return None
    return replace(state, **{k: _take(v, keep) for k, v in vars(state).items()})


class _CompactedRuns:
    """:meth:`run_compacted` for the photon tracers: one run of segments
    at a time, dead lanes dropped between runs.

    Subclass hooks: ``_runs_init(p, counter, streams) -> state`` (a dict
    of per-lane tensors and ray states that holds ``"alive"``) and
    ``_run_segments(p, counter, run, state, resp_state) -> (state,
    resp_state)``, which traces run ``run``."""

    def run_compacted(
        self,
        *,
        min_fill: float = 0.5,
        min_lanes: int = 1024,
        advance: bool = True,
        replan: bool | None = None,
        streams=None,
    ):
        """Trace one batch run by run; between runs, when the live lanes
        fill at most ``min_fill`` of the wavefront and the wavefront is
        wider than ``min_lanes``, keep the live lanes alone. Returns the
        response result, as :meth:`run` does, equal to it up to float32
        summation order.

        The signature is ``theia_tpu``'s. Its ladder halves a static-shape
        wavefront and replays a plan; here a boolean index keeps exactly
        the live lanes, so no plan is kept, ``replan`` has no effect and
        :attr:`compaction_overflow` is always 0 (no live lane is ever
        dropped). Counting the live lanes waits for the device once a
        run. Needs a histogram response and no event callback, as
        ``theia_tpu``'s does. ``streams``: another lane-id tensor than
        :meth:`streams`."""
        from ..response import HistogramHitResponse

        if not isinstance(self.response, HistogramHitResponse):
            raise ValueError(
                "run_compacted needs an additive response (histogram "
                f"family), got {type(self.response).__name__}"
            )
        if not isinstance(self.callback, EmptyEventCallback):
            raise ValueError("run_compacted does not support event callbacks")
        p = self.params()
        counter = self.rng.counter_words
        streams = self.streams() if streams is None else streams
        with torch.no_grad():
            state = self._runs_init(p, counter, streams)
            resp_state = self.response.init(streams.device)
            lanes = []
            for run in range(self.nRuns):
                state, resp_state = self._run_segments(p, counter, run, state, resp_state)
                if run == self.nRuns - 1:
                    break
                size = state["alive"].shape[0]
                n_alive = int(state["alive"].sum())  # waits for the device
                if size > max(min_lanes, 1) and n_alive <= size * min_fill:
                    state = _take(state, state["alive"])
                lanes.append(state["alive"].shape[0])
        self.compacted_lanes = lanes
        if advance:
            self.rng.advance()
        return self.response.result(p["response"], resp_state)

    @property
    def compaction_overflow(self) -> int:
        """Live photons dropped by the last :meth:`run_compacted`: 0, as a
        boolean index keeps every live lane (``theia_tpu``'s replayed
        ladder can drop some)."""
        return 0


class VolumePhotonTracer(_CompactedRuns, TracerBase):
    """Photon-resolved volume tracing against an analytic target
    (reference: src/theia/trace.py:2671-2959). Lanes and parameters live
    on ``device``: the card unless the caller names another."""

    name = "Volume Photon Tracer"
    _param_names = ("objectId", "maxTime")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        target: Target,
        wavelengthSource: WavelengthSource,
        response,
        rng: RNG,
        *,
        medium: Medium | None,
        objectId: int = 0,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        traceBBox: tuple = ((-1.0 * u.km,) * 3, (1.0 * u.km,) * 3),
        maxTime: float = 1000.0 * u.ns,
        nScatteringPerRun: int = 10,
        nRuns: int = 10,
        polarized: bool = False,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self._init_batch(batchSize, capacity)
        self.source = source
        self.target = target
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.medium = medium
        self.objectId = objectId
        self.callback = EmptyEventCallback() if callback is None else callback
        self.traceBBox = traceBBox
        self.maxTime = maxTime
        self.nScatteringPerRun = nScatteringPerRun
        self.nRuns = nRuns
        self.polarized = polarized
        self.maxHitsPerThread = 1

        # reference accounting (trace.py:2782-2785); every run starts at
        # its own dim base
        self._pre_dims = source.nRNGForward + wavelengthSource.nRNGSamples
        self._per_run = 4 * nScatteringPerRun + response.nRNGSamples
        self.nRNGSamples = self._pre_dims + 4 * nRuns * nScatteringPerRun + response.nRNGSamples
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=nRuns,  # one response record per run
                normalization=self.normalization,
                polarized=polarized,
            )
        )

    def collectStages(self) -> list[tuple[str, Component]]:
        return [
            ("photons", self.wavelengthSource),
            ("lightSource", self.source),
            ("target", self.target),
            ("tracer", self),
            ("callback", self.callback),
            ("response", self.response),
        ]

    def params(self):
        dev = self.device
        return {
            "tracer": host_dict({
                "batchSize": (self.batchSize, np.int64),
                "maxTime": (self.maxTime, np.float32),
                "lowerBBox": (self.traceBBox[0], np.float32),
                "upperBBox": (self.traceBBox[1], np.float32),
                "objectId": (self.objectId, np.int32),
            }, dev),
            "medium": None if self.medium is None else self.medium.to(dev),
            "photons": self.wavelengthSource.params(dev),
            "lightSource": self.source.params(dev),
            "target": self.target.params(dev),
            "response": self.response.params(dev),
            "callback": self.callback.params(dev),
        }

    def _propagation(self, p) -> PropagateParams:
        lo, hi = p["tracer"]["lowerBBox"], p["tracer"]["upperBBox"]
        extent = hi - lo
        return PropagateParams(
            scatter_coefficient=torch.full((), float("nan"), device=lo.device),
            lower_bbox=lo,
            upper_bbox=hi,
            max_time=p["tracer"]["maxTime"],
            max_dist=sqrt(dot(extent, extent)),
        )

    def _init_photons(self, p, rng: RNGState, streams):
        """The initial photon wavefront (wavelength + source); a photon's
        contribution tracks its survival chance alone."""
        (lam, _), rng = self.wavelengthSource.sample(p["photons"], rng)
        constants = medium_constants(p["medium"], lam)
        src, rng = self.source.sample_forward(p["lightSource"], lam, constants, rng)
        ray = RayState(
            position=src.position,
            direction=src.direction,
            wavelength=lam,
            time=src.start_time,
            lin_contrib=torch.ones_like(lam),
            log_contrib=torch.zeros_like(lam),
            constants=constants,
        )
        occluded = self.target.occluded(p["target"], ray.position)
        alive = active_lanes(streams, p) & ~occluded & ~ray.is_bad()
        return ray, alive, occluded, rng

    def _trace_batch(self, p, counter, streams):
        E = EventResultCode
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)
        ray, alive, occluded, rng = self._init_photons(p, rng, streams)

        resp_state = self.response.init(streams.device)
        n_steps = self.nRuns * self.nScatteringPerRun
        cb_state = self.callback.init(streams.shape[0], n_steps + 2, streams.device)
        all_lanes = active_lanes(streams, p)
        full = lambda code: torch.full_like(streams, int(code))
        cb_state = self.callback.on_event(p["callback"], cb_state, ray, full(E.RAY_CREATED), all_lanes, 0)
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, full(E.ERROR_TRACE_ABORT), occluded & all_lanes, 0
        )
        carry = (ray, alive, rng, resp_state, cb_state)
        for i in range(n_steps):
            carry = self._photon_step(p, prop, p["medium"], i, carry)
        ray, alive, rng, resp_state, cb_state = carry
        cb_state = self.callback.on_event(p["callback"], cb_state, ray, full(E.MAX_ITER), alive, n_steps + 1)
        if self._debug_rng:
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state

    def _photon_step(self, p, prop, medium, i: int, carry):
        """One trace segment, global step ``i`` (shared by :meth:`run` and
        the compacted runs)."""
        E = EventResultCode
        ray, alive, rng, resp_state, cb_state = carry
        pre_alive = alive
        # run-boundary dim resync (the reference's relaunch push.dim)
        if i % self.nScatteringPerRun == 0:
            base = self._pre_dims + (i // self.nScatteringPerRun) * self._per_run
            rng = replace(rng, dim=torch.full_like(rng.dim, base))

        # trace (tracer.volume.photon.common.glsl:37-79)
        uu, rng = rng.uniform()
        dist = sample_scatter_length(ray, prop, uu)
        hit = self.target.intersect(p["target"], ray.position, ray.direction)
        hit_valid = hit.valid & (hit.dist <= dist)
        dist = torch.minimum(hit.dist, dist)
        ray, code = propagate_ray(ray, dist, prop)
        ray = reattach_geometry(ray, dist, valid=hit_valid)
        ray = update_ray_is(ray, dist, prop, hit_valid)
        in_bounds = code >= 0

        item = create_hit(ray, hit.obj_position, hit.obj_normal, p["tracer"]["objectId"], hit.world_to_obj)
        detect = pre_alive & in_bounds & hit_valid & (item.contrib > 0.0)
        resp_state, rng_a = self.response.record(p["response"], resp_state, item, detect, rng)
        rng = merge_dim(rng_a, rng, detect)
        # a detected photon is absorbed (no double counting)
        code = torch.where(
            in_bounds & hit_valid, int(E.RAY_ABSORBED),
            torch.where(in_bounds, int(E.RAY_SCATTERED), code),
        ).to(torch.int32)
        step_ok = pre_alive & in_bounds & ~hit_valid

        # scatter (an unconditional draw, as the reference draws)
        (u1, u2), rng = rng.uniform2d()
        cos_theta, phi, _ = sample_scatter_dir_medium(medium, ray.direction, ray.wavelength, u1, u2)
        cos_theta = cos_theta.detach()
        scattered = scatter_ray_is(ray, scatter_dir(ray.direction, cos_theta, phi))
        if medium is not None and medium.log_phase_function is not None:
            log_p = lookup(medium.log_phase_function, cos_theta, affine=PHASE)
            scattered = replace(scattered, log_contrib=scattered.log_contrib + log_p - log_p.detach())
        ray = select_ray(step_ok, scattered, ray)

        ray, alive, rng = _sample_absorption(ray, step_ok, rng)
        code = torch.where(step_ok & ~alive, int(E.RAY_ABSORBED), code).to(torch.int32)
        cb_state = self.callback.on_event(p["callback"], cb_state, ray, code, pre_alive, i + 1)
        return ray, alive, rng, resp_state, cb_state

    # -- compacted runs --------------------------------------------------

    def _runs_init(self, p, counter, streams):
        ray, alive, _, _ = self._init_photons(p, self.rng.state_for(counter, streams), streams)
        # no dim is carried: every run resyncs to its own base
        return {"ray": ray, "alive": alive, "streams": streams}

    def _run_segments(self, p, counter, run, state, resp_state):
        prop = self._propagation(p)
        carry = (state["ray"], state["alive"], self.rng.state_for(counter, state["streams"]), resp_state, None)
        for j in range(self.nScatteringPerRun):
            carry = self._photon_step(p, prop, p["medium"], run * self.nScatteringPerRun + j, carry)
        ray, alive, _, resp_state, _ = carry
        return {**state, "ray": ray, "alive": alive}, resp_state


class ScenePhotonTracer(_CompactedRuns, SceneForwardTracer):
    """Photon-resolved scene tracing: SceneForwardTracer's surface physics
    with Russian-roulette absorption, no MIS, responses always allowed
    (reference: src/theia/trace.py:2370-2668,
    shader/tracer.scene.photon.loop.glsl)."""

    name = "Scene Photon Tracer"
    _photon_mode = True

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        wavelengthSource: WavelengthSource,
        response,
        rng: RNG,
        scene,
        *,
        nScatteringPerRun: int = 10,
        nRuns: int = 10,
        **kwargs,
    ) -> None:
        kwargs.pop("targetGuide", None)
        kwargs.pop("maxPathLength", None)
        self.nScatteringPerRun = nScatteringPerRun
        self.nRuns = nRuns
        super().__init__(
            batchSize,
            source,
            wavelengthSource,
            response,
            rng,
            scene,
            maxPathLength=nRuns * nScatteringPerRun,
            targetGuide=None,
            disableDirectLighting=False,
            **kwargs,
        )

    # -- compacted runs --------------------------------------------------

    def _runs_init(self, p, counter, streams):
        rng = self.rng.state_for(counter, streams)
        ray, medium, alive, allow, pol, rng = self._initial_carry(p, p["scene"], streams, rng)
        # the scene schedule has no per-run resync: each lane's dim is
        # carried across runs (and through compaction)
        state = {"ray": ray, "medium": medium, "alive": alive, "allow": allow, "dim": rng.dim, "streams": streams}
        if pol is not None:
            state["pol"] = pol
        return state

    def _run_segments(self, p, counter, run, state, resp_state):
        pack = p["scene"]
        prop = self._propagation(p)
        rng = replace(self.rng.state_for(counter, state["streams"]), dim=state["dim"])
        carry = (
            state["ray"], state["medium"], state["alive"], state["allow"], state.get("pol"), rng, resp_state, None,
        )
        for j in range(self.nScatteringPerRun):
            i = run * self.nScatteringPerRun + j
            carry = self._segment(p, pack, prop, carry, i, i == self.maxPathLength - 1)
        ray, medium, alive, allow, pol, rng, resp_state, _ = carry
        new = {**state, "ray": ray, "medium": medium, "alive": alive, "allow": allow, "dim": rng.dim}
        if pol is not None:
            new["pol"] = pol
        return new, resp_state
