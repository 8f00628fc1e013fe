"""Geometry gradients of the port's scene tracer through ``trace_fn()``
and the kernel histogram, against ``jax.grad`` of ``theia_tpu`` on the
same seed, on in-code icospheres (``tests/torch_flagship.build_grad_scene``):
the analogues of ``tests/test_grad_scene.py``'s
``test_arrival_time_gradient_wrt_source_position`` (l.245; here on
``accel="brute"`` in both packages, where the JAX test names
``"instanced"``, which the port does not have yet) and
``test_detector_position_gradient`` (l.361: the detector moved by
``ScenePack.translate_instance``). The source position reaches the
light curve through the reattached hit distance (``reattach_geometry``)
and the kernel histogram's arrival times; the detector position through
``translate_instance``, the hit's reconstruction from the moved
``tri_data`` rows, and the same times.

Tolerances and why:
- against ``jax.grad``: rtol 1e-3. The same paths from the same
  streams; the loss is a relative squared mismatch of two light curves,
  so it and its gradient carry the ulps of the hit distances (a soup
  hit's t agrees with JAX's to a few ulps, tests/test_torch_brute.py).
- against a central difference: the JAX tests' own limits (same sign,
  the ratio within (0.3, 3)): the reparameterized gradient misses the
  lanes that enter or leave a detector.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_grad_scene, numpy_tree

torch.set_num_threads(1)

BATCH = 4 * 1024


def _curves(kind, p0, fn, counter, streams, x):
    """The light curves with the source (``"source"``) or the detector
    (``"detector"``) moved to x along the first axis."""
    p = dict(p0)
    if kind == "source":
        p["lightSource"] = {**p["lightSource"], "position": x}
    else:
        p["scene"] = p["scene"].translate_instance(0, x)
    return fn(p, counter, streams)[0]


CASES = {
    # kind: (observed position, the position the gradient is taken at)
    "source": ((0.3, -0.2, 0.0), 0.0),
    "detector": ((0.4, 0.0, 0.0), 0.0),
}


def _jax_grad(kind):
    tracer = build_grad_scene(theia_tpu, kind, BATCH)
    fn, (p0, counter, streams) = tracer.trace_fn()
    obs_at, x0 = CASES[kind]
    obs = _curves(kind, p0, fn, counter, streams, jnp.asarray(obs_at, jnp.float32))

    def loss(x):
        c = _curves(kind, p0, fn, counter, streams, jnp.stack([x, jnp.float32(0.0), jnp.float32(0.0)]))
        return jnp.sum((c - obs) ** 2) / jnp.sum(obs**2)

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.float32(x0))
    return float(value), float(grad), p0


@pytest.mark.parametrize("kind", ["source", "detector"])
def test_geometry_gradient_matches_fd_and_jax(kind):
    tracer = build_grad_scene(theia_tpu_torch, kind, BATCH, "cpu")
    fn, (p0, counter, streams) = tracer.trace_fn()
    obs_at, x0 = CASES[kind]
    with torch.no_grad():
        obs = _curves(kind, p0, fn, counter, streams, torch.tensor(obs_at))

    def loss(x):
        c = _curves(kind, p0, fn, counter, streams, torch.stack([x, torch.tensor(0.0), torch.tensor(0.0)]))
        return ((c - obs) ** 2).sum() / (obs**2).sum()

    x = torch.tensor(x0, requires_grad=True)
    value = loss(x)
    value.backward()
    g = float(x.grad)
    assert np.isfinite(g) and value.item() > 0.0
    eps = 2e-2
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (2 * eps)
    assert np.sign(g) == np.sign(fd), (g, fd)
    assert 0.3 < abs(g / fd) < 3.0, (g, fd)
    j_value, j_grad, j_params = _jax_grad(kind)
    np.testing.assert_allclose(value.item(), j_value, rtol=1e-3)
    np.testing.assert_allclose(g, j_grad, rtol=1e-3)
    # interop carries the kernel histogram's parameters and the scene across
    carried = params_from_numpy(numpy_tree(j_params), "cpu")
    for stage in ("response", "lightSource"):
        for k, v in p0[stage].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(carried[stage][k].to(v.dtype), v), (stage, k)
    assert set(carried["response"]) == {"t0", "binSize", "bandwidth", "value"}
    assert torch.equal(carried["scene"].tri_data, p0["scene"].tri_data)


def test_translate_instance_raises_on_accelerated_packs():
    """As ``theia_tpu/scene.py:354-360``: only brute-force packs move an
    instance."""
    for accel in ("mt", "woop"):
        tracer = build_grad_scene(theia_tpu_torch, "detector", 64, "cpu")
        scene = theia_tpu_torch.scene.Scene(
            tracer.scene.instances, tracer.scene.materials, medium="water_test", accel=accel, device="cpu"
        )
        with pytest.raises(ValueError, match="brute"):
            scene.pack.translate_instance(0, torch.zeros(3))


def test_guide_sample_gradient_is_finite_where_jax_is_nan():
    """``SphereTargetGuide.sample`` differentiated in the observer (the MIS
    guide's direction follows the ray's position, which carries the
    source's and the detector's shift): from far away the cone is so
    narrow that cos theta rounds to 1, where ``theia_tpu``'s
    sqrt(max(1 - cos^2, 0)) has an infinite slope and its gradient is
    infinite or NaN (which made the flagship's geometry gradient NaN at
    path length 10).
    The port takes that square root with a zero slope there: a
    deliberate divergence, pinned here. Near the guide both agree (rtol
    1e-5: the same float32 chain)."""
    import theia_tpu.random as jrandom
    import theia_tpu.target as jtarget
    import theia_tpu_torch.random as trandom
    import theia_tpu_torch.target as ttarget

    observers = np.array([[4.0, 0.5, -0.3], [3.0, 2.0, 1.0], [5e3, 0.0, 0.0], [0.0, -4e3, 1.0]], np.float32)
    n = observers.shape[0]
    jg, tg = jtarget.SphereTargetGuide(position=(0.0, 3.0, 0.0), radius=0.6), ttarget.SphereTargetGuide(
        position=(0.0, 3.0, 0.0), radius=0.6
    )

    def jfn(obs):
        rng = jrandom.PhiloxRNG(key=42).state(jnp.arange(n, dtype=jnp.uint32))
        sample, _ = jg.sample(jg.params(), obs, rng)
        return jnp.sum(sample.direction * jnp.asarray([1.0, 2.0, 3.0]))

    j_grad = np.asarray(jax.grad(jfn)(jnp.asarray(observers)))
    obs = torch.tensor(observers, requires_grad=True)
    rng = trandom.PhiloxRNG(key=42).state(torch.arange(n, dtype=torch.int32))
    sample, _ = tg.sample(tg.params("cpu"), obs, rng)
    (sample.direction * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    t_grad = obs.grad.numpy()
    assert not np.isfinite(j_grad[2:]).any() and np.isfinite(j_grad[:2]).all()
    assert np.isfinite(t_grad).all()
    np.testing.assert_allclose(t_grad[:2], j_grad[:2], rtol=1e-5, atol=1e-7)
