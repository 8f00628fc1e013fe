"""Multiple light sources: separate pipelines, one shared histogram, on
theia_tpu_torch (examples/03_multiple_lightsources.py of theia_tpu, ported).

The radiance field is linear, so each source runs its own pipeline and the
results add. The scheduler takes named pipelines and tasks address them
by name; because both tracers share one response, the process function
does not need to know which pipeline produced a batch. The scheduler
launches each batch on its worker thread and hands the finished light
curves, as numpy arrays, to the process function on this thread.

Run: python theia_tpu_torch/examples/03_multiple_lightsources.py [--device cpu] [--batch N]
(the card by default).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

import theia_tpu_torch.units as u
from theia_tpu_torch.light import ConeLightSource, SphericalLightSource, UniformWavelengthSource
from theia_tpu_torch.material import HenyeyGreensteinPhaseFunction, MediumModel, WaterBaseModel
from theia_tpu_torch.pipeline import Pipeline, PipelineScheduler
from theia_tpu_torch.random import PhiloxRNG
from theia_tpu_torch.response import HistogramHitResponse
from theia_tpu_torch.target import SphereTarget
from theia_tpu_torch.trace import VolumeForwardTracer


class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    """Sea water at 10 degC, 35 PSU salinity, g = 0.9 HG scattering."""

    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def make_tracer(source, medium, response, key, batch: int, nScattering: int, device):
    return VolumeForwardTracer(
        batch,
        source,
        SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0 * u.m),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        response,
        PhiloxRNG(key=key),
        medium=medium,
        nScattering=nScattering,
        maxTime=500.0 * u.ns,
        device=device,
    )


def make_tracers(batch: int = 32 * 1024, nScattering: int = 8, device="cuda"):
    """The flash and the beam, sharing one water medium and one response."""
    water = WaterModel().createMedium()
    # both tracers share the response stage -> results accumulate naturally
    response = HistogramHitResponse(nBins=100, binSize=5.0 * u.ns, t0=0.0)
    flash = make_tracer(
        SphericalLightSource(position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        water, response, 0xAAAA, batch, nScattering, device,
    )
    beam = make_tracer(
        ConeLightSource(
            position=(8.0, 0.0, 0.0), direction=(-1.0, 0.0, 0.0), cosOpeningAngle=0.9,
            timeRange=(50.0, 50.0), budget=5e8,
        ),
        water, response, 0xBBBB, batch, nScattering, device,
    )
    return flash, beam


def main(device="cuda", batch: int = 32 * 1024, batches: int = 4, nScattering: int = 8,
         dispatchThread: bool = True) -> float:
    """Schedules ``batches`` batches of each source; returns the combined
    light curve's total."""
    flash, beam = make_tracers(batch, nScattering, device)
    total = np.zeros(100)

    def process(config, batch_index, result):
        nonlocal total
        total = total + np.asarray(result[0])

    scheduler = PipelineScheduler(
        [("flash", Pipeline(flash)), ("beam", Pipeline(beam))], processFn=process, dispatchThread=dispatchThread,
    )
    # `batches` batches per source, addressed by pipeline name
    scheduler.schedule([("flash", {}), ("beam", {})] * batches)
    total /= batches
    print(f"combined light curve: total={total.sum():.4g}")
    for name, t in (("flash", 0.0), ("beam", 50.0)):
        lo = int(t / 5)
        print(f"  {name} arrival window sum (bins {lo}..{lo + 20}): {total[lo:lo + 20].sum():.4g}")
    return float(total.sum())


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=32 * 1024)
    main(**vars(args.parse_args()))
