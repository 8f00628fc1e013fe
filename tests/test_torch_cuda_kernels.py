"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA device and nvcc; without them they skip. On a machine
with a card: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
``chip_smoke.py`` runs the same comparisons at the main path's shapes."""

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
