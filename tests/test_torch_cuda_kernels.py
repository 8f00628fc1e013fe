"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA device and nvcc; without them they skip. On a machine
with a card: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
``chip_smoke.py`` runs the same comparisons at the main path's shapes and
lends its helpers: run ``python -m pytest`` from the repository root, which
puts ``chip_smoke.py`` on the path."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_mt_kernel_bit_equal(cuda):
    import theia_tpu_torch
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_plain
    from torch_flagship import build_flagship, icosphere

    pack = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, device=cuda).scene.pack.mt
    rng = np.random.default_rng(0)
    n = 10_000  # not a multiple of the block size
    o = torch.as_tensor(rng.uniform(-1, 4, (n, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=cuda), dim=1)
    tmax = torch.full((n,), float("inf"), device=cuda)
    before = nearest_triangle_mt.launches
    t, i = nearest_triangle_mt(pack, o, d, tmax)
    torch.cuda.synchronize()
    assert nearest_triangle_mt.launches == before + 1
    t_p, i_p = nearest_triangle_mt_plain(pack, o, d, tmax)
    assert torch.equal(i, i_p) and torch.equal(t, t_p)


def test_philox_kernel_bit_exact(cuda):
    from theia_tpu_torch.random import philox_uniform, philox_uniform_plain

    n = 5000
    stream = torch.arange(n, dtype=torch.int32, device=cuda)
    dim = (stream * 7) % 74
    key, ctr = (0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF, 1, 0)
    for width in (1, 2):
        got = philox_uniform(key, ctr, stream, dim, width)
        assert torch.equal(got.cpu(), philox_uniform_plain(key, ctr, stream.cpu(), dim.cpu(), width))


def test_histogram_kernel(cuda):
    from theia_tpu_torch.response import histogram_add, histogram_add_plain

    rng = np.random.default_rng(1)
    n, bins, det = 20_000, 50, 3
    args = [
        torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32)),
        torch.as_tensor(rng.uniform(-5, 260, n).astype(np.float32)),
        torch.as_tensor(rng.uniform(size=n) < 0.6),
        torch.tensor(0.0),
        torch.tensor(5.0),
    ]
    oid = torch.as_tensor(rng.integers(-1, det + 1, n).astype(np.int32))
    want = histogram_add_plain(torch.zeros(bins * det), *args, bins, oid, det)
    got = histogram_add(
        torch.zeros(bins * det, device=cuda), *(a.to(cuda) for a in args), bins, oid.to(cuda), det
    )
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def _rays(n, seed, cuda):
    rng = np.random.default_rng(seed)
    o = torch.as_tensor(rng.uniform(-1, 4, (n, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(
        torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=cuda), dim=1
    )
    tmax = torch.as_tensor(
        np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.5, 5.0, n), np.inf).astype(np.float32),
        device=cuda,
    )
    return o, d, tmax


def test_woop_kernel_bit_equal(cuda):
    """3840 triangles fill 7.5 tiles of 512: the last tile is half padding."""
    import theia_tpu_torch
    from theia_tpu_torch.ops.intersect_woop import WoopPack, nearest_triangle_woop, nearest_triangle_woop_plain
    from torch_flagship import build_flagship, icosphere

    pack = build_flagship(theia_tpu_torch, icosphere(3), 64, 2, accel="woop", device=cuda).scene.pack.woop
    cpu_pack = WoopPack(pack.b.cpu(), pack.aabb, pack.lo, pack.hi, pack.n_tri, pack.chunk_box.cpu())
    o, d, tmax = _rays(10_000, 1, cuda)
    before = nearest_triangle_woop.launches
    t, i = nearest_triangle_woop(pack, o, d, tmax)
    torch.cuda.synchronize()
    assert nearest_triangle_woop.launches == before + 1
    t_p, i_p = nearest_triangle_woop_plain(cpu_pack, o.cpu(), d.cpu(), tmax.cpu())
    assert (i_p >= 0).any()
    assert torch.equal(i.cpu(), i_p) and torch.equal(t.cpu(), t_p)


def test_mt_rows_kernel_bit_equal(cuda):
    import theia_tpu_torch
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows
    from torch_flagship import build_flagship, icosphere

    pack = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, device=cuda).scene.pack
    o, d, tmax = _rays(10_000, 2, cuda)
    t, i, rows = nearest_triangle_mt_rows(pack.mt, pack.tri_data, o, d, tmax)
    t_a, i_a = nearest_triangle_mt(pack.mt, o, d, tmax)
    torch.cuda.synchronize()
    assert torch.equal(t, t_a) and torch.equal(i, i_a)
    assert torch.equal(rows, pack.tri_data[torch.clamp_min(i_a, 0).long()])


def test_histogram_grad_kernel_bit_exact(cuda):
    from theia_tpu_torch.response import histogram_grad, histogram_grad_plain

    rng = np.random.default_rng(4)
    n, bins, det = 20_000, 50, 3
    args = [
        torch.as_tensor(rng.uniform(-5, 260, n).astype(np.float32)),
        torch.as_tensor(rng.uniform(size=n) < 0.6),
        torch.tensor(0.0),
        torch.tensor(5.0),
    ]
    oid = torch.as_tensor(rng.integers(-1, det + 1, n).astype(np.int32))
    grad_state = torch.as_tensor(rng.normal(size=bins * det).astype(np.float32))
    want = histogram_grad_plain(grad_state, *args, bins, oid, det)
    got = histogram_grad(grad_state.to(cuda), *(a.to(cuda) for a in args), bins, oid.to(cuda), det)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["nearest_triangle_mt", "nearest_triangle_mt_rows", "nearest_triangle_woop"])
def test_nearest_kernels_on_hard_rays(cuda, name):
    """The three nearest-hit entry points against their plain versions, bit
    for bit, where a wrong rejection would show: adversarial rays (through
    vertices, along edges, in a triangle's plane, off a surface, with NaN
    and huge rays among them) and every query of one recorded flagship
    batch (batch 8192, path length 4)."""
    import chip_smoke
    import theia_tpu_torch
    from torch_flagship import adversarial_rays, build_flagship, icosphere

    woop = name == "nearest_triangle_woop"
    kw = dict(accel="woop", polarized=True) if woop else {}
    tracer = build_flagship(theia_tpu_torch, icosphere(3), 8192, 4, device=cuda, **kw)
    nearest = chip_smoke.Nearest(name, tracer.scene.pack)
    rows = tracer.scene.pack.tri_data[:, 18:27].cpu().numpy()
    o, d = adversarial_rays(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], seed=3, per_kind=256)
    o[5], d[6], o[7] = np.nan, np.inf, 3e38
    hard = (torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda),
            torch.full((o.shape[0],), float("inf"), device=cuda))
    before = nearest.kernel.launches
    _, hits, _ = nearest.check(hard, "adversarial rays", on_cpu=True)
    assert nearest.kernel.launches == before + 1 and hits > 0.5
    queries = chip_smoke.record_queries(
        tracer, ("nearest_triangle_woop" if woop else "nearest_triangle_mt_rows",)
    )
    assert len(queries) == 7
    for q in queries:
        nearest.check(q, "a recorded flagship query", on_cpu=False)
        # with t_max at the hit, that hit no longer counts
        t_hit = nearest.run(nearest.kernel, nearest.pack, q)[0]
        nearest.check((q[0], q[1], t_hit.contiguous()), "t_max at the hit", on_cpu=False)
