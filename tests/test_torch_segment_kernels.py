"""The flagship's forward segment as four kernels (``trace/segment.py``,
``csrc/segment.cu``): the staged route, which on the CPU runs each
kernel's plain twin, against the eager segment and against ``theia_tpu``;
which batches take it; and, on a card, each kernel against its twin.

Flagship-brute (``accel="auto"``) and flagship-mt at 4,096 lanes, path
length 4, under two Philox keys.

Tolerances and why:
(a) staged route = eager route bit for bit (a NaN equal to a NaN): the
    light curve, every lane's final RNG dim and each segment's end state
    (ray, medium, alive, allow_response, dim). The twins run the eager
    segment's own helpers in its op order, so nothing may differ.
(b) staged route against a live ``theia_tpu`` tracer on the CPU: final
    RNG dims equal on every lane (at path length 4 no lane flips a branch
    on the ulps between XLA's and torch's transcendentals), the histogram
    within ``test_torch_scene_tracer.py``'s limits: sums within rtol 1e-3,
    per-bin L1 at most 1 % of the total.
(c) ``segment_route`` is ``"stages"`` exactly where the kernels apply.
(d) on a card (``cuda`` marker; this file imports JAX only inside the
    tests that compare with it): each kernel against its plain twin bit
    for bit, on a batch's calls and on edge lanes, and the routes bit for
    bit. ``python -m pytest tests/test_torch_segment_kernels.py -m cuda
    --noconftest`` from the repository root (it borrows ``chip_smoke.py``'s
    helpers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import theia_tpu_torch
from theia_tpu_torch import accel
from theia_tpu_torch.trace import segment as seg
from torch_flagship import build_flagship, eager_route, icosphere

torch.set_num_threads(1)

BATCH = 4096
MAX_PATH = 4
CASES = [("auto", 42), ("auto", 7), ("mt", 42), ("mt", 7)]
IDS = [f"{'brute' if a == 'auto' else a}-key{k}" for a, k in CASES]

_MESH = {}


def _mesh():
    if "m" not in _MESH:
        _MESH["m"] = icosphere(3)
    return _MESH["m"]


def _port(pkg, accel_name, key, batch=BATCH, device=None, **kw):
    dev = {} if device is None else {"device": device}
    return build_flagship(pkg, _mesh(), batch, MAX_PATH, accel=accel_name, rng=lambda r: r.PhiloxRNG(key=key),
                          **dev, **kw)


def _batch(tracer, staged: bool):
    """One batch on the route asked for: the light curve, the final dims,
    each segment's end state and the queries' calls by name."""
    names = ("nearest_in_table", "nearest_in_table_rows", "target_in_table", "nearest_triangle_mt",
             "nearest_triangle_mt_rows")
    calls = dict.fromkeys(names, 0)
    saved = {name: getattr(accel, name) for name in names}

    def counting(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    tracer._debug_rng, tracer._debug_segments = True, []
    try:
        for name, fn in saved.items():
            setattr(accel, name, counting(name, fn))
        with torch.no_grad():
            assert tracer.segment_route == "stages"
            p = tracer.params()
            trace = tracer._trace_batch if staged else tracer._trace_batch_eager
            state, _, dims = trace(p, tracer.rng.counter_words, tracer.streams())
    finally:
        for name, fn in saved.items():
            setattr(accel, name, fn)
    return dict(hist=tracer.response.result(p["response"], state), dims=dims, segments=tracer._debug_segments,
                calls=calls)


_RUNS = {}


def _runs(case):
    if case not in _RUNS:
        accel_name, key = case
        tracer = _port(theia_tpu_torch, accel_name, key, device="cpu")
        _RUNS[case] = {route: _batch(tracer, route == "stages") for route in ("stages", "eager")}
    return _RUNS[case]


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dtype != torch.float32:
        return int((a != b).sum())
    nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)) & ~nan).sum())


# ---------------------------------------------------------------------------
# (a) the staged route against the eager one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_staged_light_curve_and_dims_equal_eager(case):
    runs = _runs(case)
    s, e = runs["stages"], runs["eager"]
    assert float(s["hist"].sum()) > 0.0
    assert _bits_differ(s["hist"], e["hist"]) == 0
    assert torch.equal(s["dims"], e["dims"])
    assert int(s["dims"].max()) > 10  # lanes really scattered and drew


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_staged_segment_states_equal_eager(case):
    runs = _runs(case)
    s, e = runs["stages"]["segments"], runs["eager"]["segments"]
    assert len(s) == len(e) == MAX_PATH
    for k, (a, b) in enumerate(zip(s, e)):
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, (k, name)
            assert _bits_differ(a[name], b[name]) == 0, f"segment {k}: {name}"
    # the states differ from segment to segment: the comparison saw moving lanes
    assert not torch.equal(s[0]["position"], s[-1]["position"])
    assert int(s[-1]["alive"].sum()) < int(s[0]["alive"].numel())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_staged_queries_take_no_rows(case):
    """The staged route's scans return the winner's index alone (K_surface
    and K_shadow read the rows): brute packs run ``nearest_in_table`` a
    segment and ``target_in_table`` a shadow pair, ``mt`` packs
    ``nearest_triangle_mt`` for both; the eager route keeps its queries
    with rows."""
    runs = _runs(case)
    staged, eager = runs["stages"]["calls"], runs["eager"]["calls"]
    if case[0] == "auto":
        assert staged == dict(nearest_in_table=MAX_PATH, nearest_in_table_rows=0, target_in_table=MAX_PATH - 1,
                              nearest_triangle_mt=0, nearest_triangle_mt_rows=0)
        assert eager["nearest_in_table_rows"] == MAX_PATH and eager["nearest_in_table"] == 0
    else:
        assert staged == dict(nearest_in_table=0, nearest_in_table_rows=0, target_in_table=0,
                              nearest_triangle_mt=2 * MAX_PATH - 1, nearest_triangle_mt_rows=0)
        assert eager["nearest_triangle_mt_rows"] == 2 * MAX_PATH - 1 and eager["nearest_triangle_mt"] == 0


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors the wrappers run their twins: no launch counted."""
    names = ("segment_pre", "segment_surface", "segment_scatter", "segment_shadow")
    before = [getattr(seg, name).launches for name in names]
    hist, _ = build_flagship(theia_tpu_torch, _mesh(), 256, MAX_PATH, accel="auto", device="cpu").run()
    assert [getattr(seg, name).launches for name in names] == before


# ---------------------------------------------------------------------------
# (b) the staged route against theia_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_staged_route_matches_jax(case):
    import jax
    import theia_tpu

    accel_name, key = case
    jt = _port(theia_tpu, accel_name, key)
    jt._debug_rng = True
    p = jt.params()
    j_state, _, j_dims = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    j_hist = np.asarray(jt.response.result(p["response"], j_state), np.float64)
    staged = _runs(case)["stages"]
    t_hist = staged["hist"].numpy().astype(np.float64)
    same = staged["dims"].numpy().astype(np.int64) == np.asarray(j_dims).astype(np.int64)
    assert same.mean() == 1.0, same.mean()
    d_sum = abs(t_hist.sum() / j_hist.sum() - 1.0)
    l1 = np.abs(t_hist - j_hist).sum() / j_hist.sum()
    assert d_sum <= 1e-3, d_sum
    assert l1 <= 1e-2, l1


# ---------------------------------------------------------------------------
# (c) which batches take the route
# ---------------------------------------------------------------------------


def _small(**kw):
    return build_flagship(theia_tpu_torch, _mesh(), 64, 2, device="cpu", **kw)


def test_segment_route_flagship_under_run():
    """``"stages"`` for the flagship (brute and ``mt``) under ``run()``'s
    ``torch.no_grad()``, ``"eager"`` with autograd on; ``run()`` then goes
    through the staged route's wrappers, and ``_trace_batch_eager`` (what
    the checks hold the staged route against) does not."""
    for name in ("auto", "mt"):
        tracer = _small(accel=name)
        assert tracer.segment_route == "eager"  # autograd is on here
        with torch.no_grad():
            assert tracer.segment_route == "stages"
    calls = []
    real = seg.trace_stages
    seg.trace_stages = lambda *a: calls.append(1) or real(*a)
    try:
        tracer = build_flagship(theia_tpu_torch, _mesh(), 1024, MAX_PATH, accel="auto", device="cpu")
        hist, _ = tracer.run()
        with torch.no_grad(), eager_route(tracer):
            tracer.run()
            tracer._trace_batch_eager(tracer.params(), tracer.rng.counter_words, tracer.streams())
        assert "_trace_batch" not in vars(tracer)  # eager_route put the method back
    finally:
        seg.trace_stages = real
    assert calls == [1] and float(hist.sum()) > 0.0


def test_segment_route_trace_fn_keeps_autograd():
    """``trace_fn()`` with a parameter that requires a gradient takes the
    eager segment, and its gradient flows."""
    tracer = build_flagship(theia_tpu_torch, _mesh(), 1024, MAX_PATH, accel="auto", device="cpu")
    fn, (p, counter, streams) = tracer.trace_fn()
    media = p["scene"].media
    row = media.handle("water")
    table = media.tables["absorption_coef"]
    scale = torch.zeros((), requires_grad=True)
    patched = torch.cat([table[:row], table[row:row + 1] * torch.exp(scale), table[row + 1:]])
    p = dict(p, scene=dataclasses.replace(p["scene"], media=dataclasses.replace(
        media, tables={**media.tables, "absorption_coef": patched})))
    real = seg.trace_stages
    seg.trace_stages = lambda *a: pytest.fail("trace_fn took the staged route")
    try:
        assert tracer.segment_route == "eager"
        state, _ = fn(p, counter, streams)
    finally:
        seg.trace_stages = real
    state.sum().backward()
    assert scale.grad is not None and torch.isfinite(scale.grad) and float(scale.grad) != 0.0


def _excluded():
    from theia_tpu_torch import response, target
    from theia_tpu_torch.random import SobolQRNG
    from torch_flagship import build_photon_flagship

    return {
        "polarized": lambda: _small(accel="auto", polarized=True),
        "photon mode": lambda: build_photon_flagship(theia_tpu_torch, _mesh(), 64, "cpu"),
        "unguided": lambda: _small(accel="auto", guided=False),
        "disk guide": lambda: _small(accel="auto", guide="disk"),
        "KernelHistogramHitResponse": lambda: _small(
            accel="auto", response=response.KernelHistogramHitResponse(nBins=100, binSize=5.0, bandwidth=5.0)),
        "HitRecorder": lambda: _small(accel="auto", response=response.HitRecorder()),
        "StoreTimeHitResponse": lambda: _small(accel="auto", response=response.StoreTimeHitResponse()),
        "SobolQRNG": lambda: _small(accel="auto", rng=lambda r: SobolQRNG(seed=1, dims=64)),
        "woop": lambda: _small(accel="woop"),
        "bvh": lambda: _small(accel="bvh"),
        "instanced": lambda: _small(accel="instanced"),
        "sphere guide subclass": lambda: _guide_subclass(target),
    }


def _guide_subclass(target):
    class Guide(target.SphereTargetGuide):
        pass

    tracer = _small(accel="auto")
    tracer.targetGuide = Guide(position=(0.0, 3.0, 0.0), radius=0.6)
    return tracer


EXCLUDED = [
    "polarized", "photon mode", "unguided", "disk guide", "KernelHistogramHitResponse", "HitRecorder",
    "StoreTimeHitResponse", "SobolQRNG", "woop", "bvh", "instanced", "sphere guide subclass",
]


@pytest.mark.parametrize("name", EXCLUDED)
def test_segment_route_eager_where_the_kernels_do_not_apply(name):
    tracer = _excluded()[name]()
    with torch.no_grad():
        assert tracer.segment_route == "eager", name
    real = seg.trace_stages
    seg.trace_stages = lambda *a: pytest.fail(f"{name} took the staged route")
    try:
        tracer.run()
    finally:
        seg.trace_stages = real


# ---------------------------------------------------------------------------
# (d) on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("accel_name", ["auto", "mt"])
def test_segment_kernels_equal_their_twins(cuda, accel_name):
    """Every call of the four kernels in one staged batch and the edge lanes
    (total internal reflection, grazing incidence, media mismatch, out of
    the box, past ``maxTime``, dead, NaN and infinite lanes, misses)
    against the plain twins on the card, bit for bit."""
    import chip_smoke

    tracer = build_flagship(theia_tpu_torch, _mesh(), 65_536, MAX_PATH, accel=accel_name, device=cuda)
    calls = chip_smoke.record_segment_calls(tracer)
    assert len(calls) == 4 * MAX_PATH - 2
    for name, args in calls:
        chip_smoke.hold_segment_call(name, args)
    s, lanes = next(a for n, a in calls if n == "segment_scatter")[:2]
    chip_smoke.hold_segment_edges(s, lanes, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("accel_name", ["auto", "mt"])
def test_segment_routes_equal_on_the_card(cuda, accel_name):
    import chip_smoke

    build = lambda: build_flagship(theia_tpu_torch, _mesh(), 65_536, chip_smoke.MAX_PATH, accel=accel_name,
                                   device=cuda)
    chip_smoke.segment_routes_equal(accel_name, build)
