"""Quasi-random sampling: light curves that converge faster with
SobolQRNG, on theia_tpu_torch (examples/11_quasirandom_sampling.py of
theia_tpu, ported).

``SobolQRNG`` (Owen-scrambled Sobol points, drawn by ``csrc/sobol.cu`` on
the card) takes ``PhiloxRNG``'s place in any tracer. The same volume
configuration runs under both generators, and each one's spread across
replicates is estimated:

* Philox replicates are successive counter blocks (``rng.advance()``:
  the same key, disjoint draws);
* Sobol replicates are fresh scramble seeds (independent randomizations
  of the same point set; successive blocks of one scramble are parts of
  one estimate, not replicates).

Run: python theia_tpu_torch/examples/11_quasirandom_sampling.py [--device cpu] [--batch N]
(the card by default).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

import theia_tpu_torch.units as u
from theia_tpu_torch.light import SphericalLightSource, UniformWavelengthSource
from theia_tpu_torch.material import DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel
from theia_tpu_torch.random import PhiloxRNG, SobolQRNG
from theia_tpu_torch.response import HistogramHitResponse
from theia_tpu_torch.target import InnerSphereTarget
from theia_tpu_torch.trace import VolumeForwardTracer


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    def __init__(self) -> None:
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.005, mu_s=0.01)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.3)


def build(rng, batch: int, device):
    return VolumeForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=50.0),
        UniformWavelengthSource(lambdaRange=(400.0 * u.nm, 500.0 * u.nm)),
        HistogramHitResponse(nBins=40, binSize=20.0 * u.ns, t0=0.0),
        rng,
        medium=Model().createMedium(num_lambda=32, num_theta=64),
        nScattering=6,
        scatterCoefficient=0.02,
        device=device,
    )


def replicate_curves(kind: str, reps: int, batch: int, device) -> np.ndarray:
    tracer = build(SobolQRNG(seed=1, dims=64) if kind == "sobol" else PhiloxRNG(key=7), batch, device)
    curves = []
    for r in range(reps):
        if kind == "sobol":
            # a fresh Owen randomization of the same block of points
            tracer.rng.seed = 0x9E3779B9 * (r + 1) & 0xFFFFFFFF
            curve, _ = tracer.run(advance=False)
        else:
            curve, _ = tracer.run()  # the next counter block
        curves.append(curve.double().cpu().numpy())
    return np.stack(curves)


def main(device="cuda", batch: int = 8 * 1024, reps: int = 8, check: bool = True) -> float:
    """Returns the across-replicate variance ratio Philox / Sobol."""
    cp = replicate_curves("philox", reps, batch, device)
    cq = replicate_curves("sobol", reps, batch, device)
    rel = abs(cp.mean() - cq.mean()) / cp.mean()
    vp, vq = cp.var(0, ddof=1).sum(), cq.var(0, ddof=1).sum()
    print(f"mean curves agree to {rel * 100:.1f}%")
    print(f"across-replicate variance: philox {vp:.4g}, sobol {vq:.4g} -> variance ratio {vp / vq:.1f}x")
    if check:
        assert rel < 0.05, rel
        assert vp / vq > 1.5, vp / vq
        print("sobol variance win confirmed")
    return vp / vq


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=8 * 1024)
    main(**vars(args.parse_args()))
