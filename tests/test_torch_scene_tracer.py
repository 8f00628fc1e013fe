"""The slice as a whole: the port's flagship SceneForwardTracer against the
live JAX tracer on CPU (accel="mt", batch 4096, path length 10,
PhiloxRNG(key=42), the same icosphere in both packages).

Tolerances and why:
(a) final per-lane RNG dims equal on >= 99.5 % of lanes. The dims decide
    which Philox words every later draw reads; they match bit for bit
    until a lane takes another branch. Transcendentals (exp, log, sqrt,
    sin, cos) differ by ulps between XLA and torch on CPU, and so does the
    Moeller-Trumbore reciprocal (see test_torch_intersect_mt.py), so a few
    lanes flip a comparison such as ``u_surf < r_coef``.
(b) histogram sums within rtol 1e-3 and per-bin L1 difference at most 1 %
    of the total: the same ulp differences move each lane's contribution
    by ~1e-6, and the rare flipped lane moves its whole contribution.
(c) a second run() advances the RNG offset by nRNGSamples, as JAX does,
    and its histogram agrees with JAX's second batch within (b).
(d) the port run with params_from_numpy(JAX params) equals the port run
    with its own params bit for bit: the same tensors go in.
"""

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch import accel
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_flagship, icosphere, numpy_tree

# the suite runs several xdist workers on one shared CPU: torch's intra-op
# threads in each of them oversubscribe it (the port's tests took 10x
# longer with the default thread count than with one thread per worker)
torch.set_num_threads(1)

BATCH = 4096
MAX_PATH = 10


def _hist_stats(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return abs(got.sum() / want.sum() - 1.0), np.abs(got - want).sum() / want.sum()


@pytest.fixture(scope="module")
def runs():
    mesh = icosphere(3)
    jt = build_flagship(theia_tpu, mesh, BATCH, MAX_PATH)
    jt._debug_rng = True
    p = jt.params()
    fn = jax.jit(jt._trace_batch)
    streams = jt.streams()
    j_state, _, j_dims = fn(p, jt.rng.counter_words, streams)
    out = {"j_hist": np.asarray(jt.response.result(p["response"], j_state))}
    out["j_dims"] = np.asarray(j_dims).astype(np.int64)
    jt.rng.advance()  # what run() does after its batch
    out["j_offset1"] = jt.rng.offset
    j_state2, _, _ = fn(p, jt.rng.counter_words, streams)
    out["j_hist2"] = np.asarray(jt.response.result(p["response"], j_state2))
    jt.rng.advance()
    out["j_offset2"] = jt.rng.offset

    tt = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, device="cpu")
    assert tt.nRNGSamples == jt.nRNGSamples
    tt._debug_rng = True
    tp = tt.params()
    # count the batch's calls of the two Moeller-Trumbore queries
    calls = out["t_query_calls"] = {"nearest_triangle_mt": 0, "nearest_triangle_mt_rows": 0}

    def counting(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    saved = {name: getattr(accel, name) for name in calls}
    for name, fn in saved.items():
        setattr(accel, name, counting(name, fn))
    try:
        with torch.no_grad():
            t_state, _, t_dims = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    finally:
        for name, fn in saved.items():
            setattr(accel, name, fn)
    out["t_hist"] = tt.response.result(tp["response"], t_state).numpy()
    out["t_dims"] = t_dims.numpy().astype(np.int64)
    tt._debug_rng = False
    hist, _ = tt.run(params=params_from_numpy(numpy_tree(p), "cpu"))
    out["t_hist_interop"] = hist.numpy()
    out["t_offset1"] = tt.rng.offset
    hist2, _ = tt.run()
    out["t_hist2"] = hist2.numpy()
    out["t_offset2"] = tt.rng.offset
    return out


def test_rng_dims_match(runs):
    same = runs["t_dims"] == runs["j_dims"]
    assert runs["j_dims"].max() > 40  # paths really ran many segments
    assert same.mean() >= 0.995, same.mean()


def test_histogram_matches(runs):
    assert np.isfinite(runs["t_hist"]).all() and runs["t_hist"].sum() > 0
    d_sum, l1 = _hist_stats(runs["t_hist"], runs["j_hist"])
    assert d_sum <= 1e-3, d_sum
    assert l1 <= 1e-2, l1


def test_second_run_advances_like_jax(runs):
    assert runs["t_offset1"] == runs["j_offset1"] == 74
    assert runs["t_offset2"] == runs["j_offset2"] == 148
    d_sum, l1 = _hist_stats(runs["t_hist2"], runs["j_hist2"])
    assert d_sum <= 1e-3, d_sum
    assert l1 <= 1e-2, l1
    assert not np.array_equal(runs["t_hist2"], runs["t_hist"])


def test_params_from_numpy_bit_equal(runs):
    np.testing.assert_array_equal(runs["t_hist_interop"], runs["t_hist"])


def test_cpu_run_launches_no_kernel(runs):
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows
    from theia_tpu_torch.random import philox_uniform
    from theia_tpu_torch.response import histogram_add

    assert nearest_triangle_mt.launches == nearest_triangle_mt_rows.launches == 0
    assert philox_uniform.launches == histogram_add.launches == 0


def test_mt_path_takes_rows_from_the_query(runs):
    """Every query of the batch (10 primary, 9 shadow) goes through the
    query that also returns the winners' rows, none through the other;
    with tri_data being differentiated the torch gather takes over, and
    both give the same hit."""
    assert runs["t_query_calls"] == {"nearest_triangle_mt": 0, "nearest_triangle_mt_rows": 2 * MAX_PATH - 1}
    tracer = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, device="cpu")
    pack = tracer.scene.pack
    rng = np.random.default_rng(5)
    o = torch.as_tensor(rng.uniform(-1, 4, (512, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32)), dim=1)
    medium = torch.zeros(512, dtype=torch.int32)
    from_query = accel.intersect_scene(pack, medium, o, d, torch.inf)
    import dataclasses

    leaf = dataclasses.replace(pack, tri_data=pack.tri_data.clone().requires_grad_(True))
    gathered = accel.intersect_scene(leaf, medium, o, d, torch.inf)
    assert from_query.valid.any() and gathered.world_pos.requires_grad
    for f in dataclasses.fields(from_query):
        assert torch.equal(getattr(from_query, f.name), getattr(gathered, f.name).detach()), f.name


def test_unported_configurations_raise():
    """What is still unported raises: the brute-force scan and a tracer
    without a target guide (polarized tracing is ported now)."""
    mesh = icosphere(1)
    with pytest.raises(NotImplementedError, match="brute"):
        build_flagship(theia_tpu_torch, mesh, 64, 2, accel="brute", device="cpu")
    tracer = build_flagship(theia_tpu_torch, mesh, 64, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="target guide"):
        type(tracer)(
            64, tracer.source, tracer.wavelengthSource, tracer.response,
            tracer.rng, tracer.scene, polarized=True, device="cpu",
        )


def test_entry_points_default_to_the_card():
    """``Scene``, ``SceneForwardTracer`` and ``MaterialStore.pack`` run on
    the card unless the caller names another device: without a card the
    default raises and names ``device="cpu"``; it never runs on the CPU
    unasked."""
    import torch

    from theia_tpu_torch.component import resolve_device

    mesh = icosphere(1)
    if torch.cuda.is_available():
        tracer = build_flagship(theia_tpu_torch, mesh, 64, 2)
        assert tracer.device.type == tracer.scene.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flagship(theia_tpu_torch, mesh, 64, 2)  # MaterialStore.pack is the first to refuse
    cpu = build_flagship(theia_tpu_torch, mesh, 64, 2, device="cpu")
    for make in (
        lambda: theia_tpu_torch.scene.Scene(cpu.scene.instances, cpu.scene.materials, medium="water", accel="mt"),
        lambda: theia_tpu_torch.trace.scene.SceneForwardTracer(
            64, cpu.source, cpu.wavelengthSource, cpu.response, cpu.rng, cpu.scene, targetGuide=cpu.targetGuide
        ),
        lambda: resolve_device("cuda:0"),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
