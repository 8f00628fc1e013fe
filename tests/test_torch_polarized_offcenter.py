"""Check (c) of the polarized slice test: the light source moved to
(3.0, 0.6, 0.0), still inside the inner glass shell, so direct rays meet
the shells at oblique incidence where the Fresnel polarizers are not the
identity (centred, every direct ray is normal to both shells and
polarization changes nothing measurable).

Run at batch 16,384 rather than 4096: the polarized and unpolarized light
curves differ mostly through a few lanes whose Stokes intensity the
shells change strongly; at 4096 the two differ by 1.1e-4, at 16,384 by
2.7 % (both measured, port and JAX alike). Checks: (a) and (b) of
tests/test_torch_polarized_tracer.py against JAX, and the port's
polarized histogram more than 1 % from its unpolarized one. Measured:
RNG dims 100 % equal, L1 1.4e-7 against JAX; 2.7 % from unpolarized. Together with
the match against JAX that shows the polarizer branches really run.
"""

import numpy as np
import pytest
import torch

import theia_tpu_torch
from test_torch_polarized_tracer import MAX_PATH, hist_stats, trace_both
from torch_flagship import build_flagship, icosphere

# the suite runs several xdist workers on one shared CPU: torch's intra-op
# threads in each of them oversubscribe it (the port's tests took 10x
# longer with the default thread count than with one thread per worker)
torch.set_num_threads(1)

BATCH = 16_384
SOURCE = (3.0, 0.6, 0.0)


@pytest.fixture(scope="module")
def runs():
    _, _, j_hist, j_dims, _, t_hist, t_dims = trace_both(BATCH, SOURCE)
    unpol = build_flagship(
        theia_tpu_torch, icosphere(3), BATCH, MAX_PATH, accel="woop", device="cpu",
        source_position=SOURCE,
    )
    hist, _ = unpol.run()
    return dict(j_hist=j_hist, j_dims=j_dims, t_hist=t_hist, t_dims=t_dims, unpol=hist.numpy())


def test_offcenter_matches_jax(runs):
    assert (runs["t_dims"] == runs["j_dims"]).mean() >= 0.995
    d_sum, l1 = hist_stats(runs["t_hist"], runs["j_hist"])
    assert d_sum <= 1e-3, d_sum
    assert l1 <= 1e-2, l1


def test_polarization_changes_the_light_curve(runs):
    assert np.isfinite(runs["t_hist"]).all() and runs["unpol"].sum() > 0
    d_sum, l1 = hist_stats(runs["t_hist"], runs["unpol"])
    assert l1 > 1e-2, l1
