"""``params()`` snapshots without a blocking copy (``component.host_tensors``).

A component's numbers and arrays go into one host buffer a snapshot (on a
card a fresh pinned one, copied with ``non_blocking=True``), each
parameter a view of its own span, so a launch queues one copy and waits
for no batch queued before it. Held here on the CPU, where the same
packing runs without the copy: the values are those a fresh tracer gives,
a snapshot taken before ``setParams`` keeps its values, a parameter that
is already a tensor (with its graph) passes through, and a component's
scalars share one buffer. No JAX: the reference here is the port's own
fresh tracer.
"""

import dataclasses

import numpy as np
import pytest
import torch

import theia_tpu_torch
from theia_tpu_torch.component import host_dict, host_tensors
from torch_flagship import build_volume_flagship

torch.set_num_threads(1)


def flat(tree, prefix=""):
    """A params tree as {path: tensor or value}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return flat({f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}, prefix)
    return {prefix: tree}


def same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal dtype, shape and values, NaN equal to NaN (a tracer's
    default scatter coefficient is NaN)."""
    return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(torch.isnan(x), torch.isnan(y))
            and torch.equal(x.nan_to_num(), y.nan_to_num()))


def same_tree(a, b) -> None:
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        assert same(x, y) if isinstance(x, torch.Tensor) else x == y, k


def test_host_tensors_pack_one_buffer():
    """Numbers, tuples and arrays of each dtype come back with their shape
    and dtype, as views of one buffer at 16-byte aligned spans; a tensor
    and None pass through as they are."""
    leaf = torch.ones(2, requires_grad=True)
    out = host_tensors([(1.5, np.float32), ((1, 2, 3), np.float32), (7, np.int64), (None, None), (leaf, np.float32),
                        (np.eye(3)[:, ::2], np.float32), (3, np.int32), (np.arange(3.0), None), (True, np.float32)],
                       "cpu")
    assert out[3] is None and out[4] is leaf
    want = [torch.tensor(1.5), torch.tensor([1.0, 2.0, 3.0]), torch.tensor(7), None, leaf,
            torch.tensor(np.eye(3)[:, ::2], dtype=torch.float32), torch.tensor(3, dtype=torch.int32),
            torch.arange(3.0, dtype=torch.float64), torch.tensor(1.0)]
    packed = [o for o in out if o is not None and o is not leaf]
    assert len({o.untyped_storage().data_ptr() for o in packed}) == 1
    for o, w in zip(out, want):
        if o is not None and o is not leaf:
            assert o.dtype == w.dtype and o.shape == w.shape and torch.equal(o, w)
            assert (o.data_ptr() - packed[0].data_ptr()) % 16 == 0
    assert host_tensors([(leaf, np.float32), (None, None)], "cpu") == [leaf, None]


def test_params_after_set_params_are_a_fresh_tracers():
    """``setParams`` on the source, the target, the wavelength source and
    the response, then ``params()``: the same tree, dtypes and values as a
    tracer built with those values; every component's scalars share one
    buffer."""
    P = theia_tpu_torch
    tracer = build_volume_flagship(P, 64, "cpu")
    tracer.source.setParams(position=(2.0, -3.0, 0.5), budget=5e8)
    tracer.target.setParams(radius=3.0)
    tracer.wavelengthSource.setParams(lambdaRange=(420.0, 480.0))
    tracer.response.setParams(t0=-2.0, binSize=4.0)
    fresh = build_volume_flagship(
        P, 64, "cpu",
        source=P.light.SphericalLightSource(position=(2.0, -3.0, 0.5), timeRange=(0.0, 0.0), budget=5e8),
        target=P.target.SphereTarget(position=(0.0, 0.0, 0.0), radius=3.0),
        response=P.response.HistogramHitResponse(nBins=100, binSize=4.0, t0=-2.0),
    )
    fresh.wavelengthSource.setParams(lambdaRange=(420.0, 480.0))
    p = tracer.params()
    same_tree(p, fresh.params())
    for stage in ("tracer", "lightSource", "target", "photons"):
        tensors = [t for t in flat(p[stage]).values() if isinstance(t, torch.Tensor)]
        assert len(tensors) > 1 and len({t.untyped_storage().data_ptr() for t in tensors}) == 1, stage
    assert p["tracer"]["batchSize"].dtype == torch.int64 and p["tracer"]["objectId"].dtype == torch.int32


def test_snapshot_keeps_its_values_after_set_params():
    """A snapshot taken before ``setParams`` holds the old values; the
    next one the new."""
    tracer = build_volume_flagship(theia_tpu_torch, 64, "cpu")
    before = tracer.params()
    kept = {k: v.clone() for k, v in flat(before).items() if isinstance(v, torch.Tensor)}
    tracer.source.setParams(position=(9.0, 9.0, 9.0), budget=1.0)
    tracer.response.setParams(t0=7.0)
    tracer.setParams(maxTime=11.0)
    after = tracer.params()
    for k, v in flat(before).items():
        if isinstance(v, torch.Tensor):
            assert same(v, kept[k]), k
    assert after["lightSource"]["position"].tolist() == [9.0, 9.0, 9.0]
    assert float(after["response"]["t0"]) == 7.0 and float(after["tracer"]["maxTime"]) == 11.0
    assert before["lightSource"]["position"].tolist() == [-1.0, -7.0, 0.0]


def test_graph_carrying_parameter_keeps_its_gradient():
    """A kernel histogram's ``t0`` that is a tensor with a graph passes
    through ``params()`` as the same tensor, and a batch's light curve
    through ``trace_fn()`` gives it a finite, nonzero gradient, the same
    as when the tensor is patched into a snapshot by hand; the other
    parameters are still packed."""
    kde = theia_tpu_torch.response.KernelHistogramHitResponse(nBins=100, binSize=5.0, t0=0.0, bandwidth=5.0)
    tracer = build_volume_flagship(theia_tpu_torch, 1024, "cpu", nScattering=2, response=kde)
    grads = []
    for by_hand in (False, True):
        leaf = torch.zeros((), requires_grad=True)
        t0 = leaf * 2.0
        kde.t0 = 0.0 if by_hand else t0
        fn, (p, counter, streams) = tracer.trace_fn()
        if by_hand:
            p["response"]["t0"] = t0
        assert p["response"]["t0"] is t0 and not p["response"]["binSize"].requires_grad
        state, _ = fn(p, counter, streams)
        curve = tracer.response.result(p["response"], state)
        (curve * torch.linspace(0.0, 1.0, curve.shape[0])).sum().backward()
        grads.append(leaf.grad)
    assert torch.isfinite(grads[0]) and grads[0] != 0 and torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_dict_keeps_names_and_devices(device):
    out = host_dict({"a": (1.0, np.float32), "b": ((1, 2), np.int32)}, device)
    assert list(out) == ["a", "b"] and out["a"].device.type == device and out["b"].dtype == torch.int32
