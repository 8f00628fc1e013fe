"""theia_tpu_torch.parallel against theia_tpu.parallel on the CPU: the
cases of tests/test_parallel.py, with the port's sharded runs in a world
of 4 gloo processes (tests/_torch_parallel_worker.py, started once for
this file) and JAX's on conftest's 8 CPU devices.

Tolerances and why:
(a) sharded against single in the port: the histogram at JAX's own rtol
    2e-4 / atol 1e-3 (the float sums of 4 ranks' states in another order),
    the event statistics exactly (integer counts), and each rank's lanes'
    final RNG dims equal to the single run's slice bit for bit: a rank
    traces the global stream ids of its block, so every draw is the same.
    All ranks hold the same summed bits.
(b) the port's sharded curve against JAX's sharded curve on 4 of the 8
    devices, the same 4 blocks of lanes: the port's volume agreement
    (tests/test_torch_volume.py): the sum within rtol 1e-5 and every bin
    within 1e-5 of the largest bin. Against JAX's 8 devices at JAX's rtol
    2e-4 of (a): the 8 partial sums round otherwise (JAX's own 8-way curve
    is 2.3e-5 of the largest bin from its single-device one, measured).
(c) the sharded gradient against the single one at JAX's rtol 2e-3 / atol
    1e-2, its sum within 1e-4 of the single sum (world-size times would be
    4): each rank's local backward gives its own share, and
    reduce_gradients sums the shares.
(d) the instanced scene sharded against its single run at JAX's rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu.parallel as jpar
import theia_tpu_torch
import theia_tpu_torch.parallel as tpar
import _torch_parallel_worker as W

torch.set_num_threads(1)

WORLD = 4
JOBS = ("volume", "gradient", "instanced")
RTOL_VOLUME = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo world's results by job, joined at the first request, so
    the ranks run while a test computes its references."""
    out = tmp_path_factory.mktemp("gloo")
    procs = W.start_world(out, WORLD, JOBS)
    results = {}

    def get(job):
        if not results:
            results.update(W.join_world(procs, out, JOBS))
        return results[job]

    yield get
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def port_single(tracer, batch):
    """One batch of the port's tracer on every lane in one process, with
    its lanes' RNG dims."""
    tracer._debug_rng = True
    with torch.no_grad():
        return tracer._trace_batch(tracer.params(), tracer.rng.counter_words, torch.arange(batch, dtype=torch.int32))


def test_sharded_equals_single(world):
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    batch = W.PARALLEL_BATCH
    hist1, stats1, dims1 = port_single(W.build_volume(theia_tpu_torch, batch, "cpu"), batch)
    jt = W.build_volume(theia_tpu, batch)
    jax_sharded = {}
    for n_dev in (8, WORLD):
        jmesh = jpar.make_photon_mesh(jax.devices()[:n_dev])
        jax_sharded[n_dev] = jpar.shard_trace(jt, jmesh)(
            jt.params(), jt.rng.counter_words, jpar.sharded_streams(batch, jmesh))
    ranks = world("volume")
    per = batch // WORLD
    for r, got in enumerate(ranks):
        assert torch.equal(got["streams"], torch.arange(r * per, (r + 1) * per, dtype=torch.int32))
        assert torch.equal(got["dims"], dims1[r * per:(r + 1) * per]), f"rank {r}'s RNG dims"
        assert torch.equal(got["hist"].view(torch.int32), ranks[0]["hist"].view(torch.int32))
        assert torch.equal(got["stats"], ranks[0]["stats"])
    hist4 = ranks[0]["hist"].numpy()
    assert hist1.sum() > 0
    np.testing.assert_allclose(hist4, hist1.numpy(), rtol=2e-4, atol=1e-3)
    np.testing.assert_array_equal(ranks[0]["stats"].numpy(), stats1.numpy())
    for jhist, jstats in jax_sharded.values():
        np.testing.assert_array_equal(ranks[0]["stats"].numpy(), np.asarray(jstats))
    np.testing.assert_allclose(hist4, np.asarray(jax_sharded[8][0]), rtol=2e-4, atol=1e-3)
    want = np.asarray(jax_sharded[WORLD][0], np.float64)
    assert abs(hist4.sum() / want.sum() - 1.0) <= RTOL_VOLUME
    assert np.abs(hist4 - want).max() <= RTOL_VOLUME * want.max()


def test_sharded_gradient(world):
    """The gradient of sum(histogram) in the absorption table: the sharded
    one (a local backward on each rank, then reduce_gradients) equals the
    single-device one, not world-size times it, and JAX's sharded one."""
    batch = W.GRAD_BATCH
    tracer = W.build_volume(theia_tpu_torch, batch, "cpu", callback=False)
    g_single = W.absorption_grad(tracer, tracer._trace_batch, torch.arange(batch, dtype=torch.int32)).grad.numpy()

    jt = W.build_volume(theia_tpu, batch, callback=False)
    p0, counter = jt.params(), jt.rng.counter_words
    jmesh = jpar.make_photon_mesh()
    from jax.sharding import PartitionSpec as Spec

    def total(tbl, streams):
        import dataclasses

        p = dict(p0, medium=dataclasses.replace(p0["medium"], absorption_coef=tbl))
        return jnp.sum(jt._trace_batch(p, counter, streams)[0])

    def sharded_total(tbl, streams):
        inner = lambda tbl, streams: jax.lax.psum(total(tbl, streams), "batch")
        return jax.shard_map(inner, mesh=jmesh, in_specs=(Spec(), Spec("batch")), out_specs=Spec(),
                             check_vma=False)(tbl, streams)

    g_jax = np.asarray(jax.jit(jax.grad(sharded_total))(
        jnp.asarray(p0["medium"].absorption_coef), jpar.sharded_streams(batch, jmesh)))

    ranks = world("gradient")
    g = ranks[0]["grad"].numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["grad"].numpy(), g)
    assert np.abs(g_single).max() > 0
    np.testing.assert_allclose(g, g_single, rtol=2e-3, atol=1e-2)
    assert abs(g.sum() / g_single.sum() - 1.0) <= 1e-4, g.sum() / g_single.sum()
    local = np.stack([r["local"].numpy() for r in ranks])
    assert all(abs(x.sum()) < abs(g.sum()) for x in local), "a rank's own share is part of the sum"
    np.testing.assert_allclose(local.sum(0), g, rtol=1e-5)
    np.testing.assert_allclose(g, g_jax, rtol=2e-3, atol=1e-2)


def test_sharded_instanced_scene_equals_single(world):
    single, _ = W.build_instanced(theia_tpu_torch, W.INSTANCED_BATCH, "cpu").run(advance=False)
    ranks = world("instanced")
    assert single.sum() > 0
    for r in ranks:
        np.testing.assert_allclose(r["hist"].numpy(), single.numpy(), rtol=1e-5)


def test_multihost_runner_single_params_snapshot():
    """shard_trace_multihost takes one params() snapshot a batch, so a
    streaming source advances one block a batch (a world of one process)."""
    tracer, src = W.build_streaming(theia_tpu_torch, 4 * 1024, "cpu")
    mesh = tpar.make_photon_mesh(["cpu"])
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    run = tpar.shard_trace_multihost(tracer, mesh)
    assert src.offset == 0
    curve, _ = run()
    assert src.offset == 4 * 1024
    assert isinstance(curve, np.ndarray) and curve.sum() > 0
    run()
    assert src.offset == 8 * 1024


def test_world_of_one_is_the_plain_batch():
    """A world of one process runs the tracer's own step, with no
    collective: the same bits as _trace_batch."""
    tracer = W.build_volume(theia_tpu_torch, 1024, "cpu")
    mesh = tpar.make_photon_mesh("cpu")
    p, counter = tracer.params(), tracer.rng.counter_words
    with torch.no_grad():
        hist, stats = tpar.shard_trace(tracer, mesh)(p, counter, tpar.sharded_streams(1024, mesh))
        want_hist, want_stats = tracer._trace_batch(p, counter, tracer.streams())
    assert torch.equal(hist, want_hist) and torch.equal(stats, want_stats)
    assert tpar.replicate_tree(p, mesh)["medium"].absorption_coef.device == torch.device("cpu")
    assert isinstance(tpar.fetch({"h": hist})["h"], np.ndarray)


def test_sharded_streams_divisibility():
    mesh = tpar.PhotonMesh(None, 1, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible by the device count"):
        tpar.sharded_streams(1024, mesh)
    with pytest.raises(ValueError, match="divisible by the device count"):
        tpar.global_streams(1024, mesh)
    assert tpar.sharded_streams(1023, mesh).tolist() == list(range(341, 682))


def test_make_photon_mesh_refuses_several_devices():
    with pytest.raises(ValueError, match="initialize"):
        tpar.make_photon_mesh(["cpu", "cpu"])
    assert tpar.make_photon_mesh(["cpu"]).device == torch.device("cpu")
