"""The port's ``cascades`` (host code, its own copy) against the live
``theia_tpu.cascades``: the fit constants, ``createCascadeParameters`` in
water and ice, and ``createParamsFromParticle`` for every ``ParticleType``
(the light source's class by name, its parameters and light yield equal,
the same errors for a track without a length and for particles that make
no light). Both packages run the same float64 numpy and scipy code, so the
tolerance is equality."""

import dataclasses

import numpy as np
import pytest

import theia_tpu.cascades as jc
import theia_tpu_torch.cascades as tc

PRIMARIES = ("EMinus", "EPlus", "Gamma", "PiPlus", "PiMinus", "K0_Long", "PPlus", "PMinus", "Neutron")


def test_names_and_constants_match():
    assert sorted(tc.__all__) == sorted(jc.__all__)
    for name in PRIMARIES:
        assert dataclasses.astuple(getattr(tc, name)) == dataclasses.astuple(getattr(jc, name)), name
    assert (tc.X0_ice, tc.X0_water, tc.rho_ice, tc.rho_water) == (jc.X0_ice, jc.X0_water, jc.rho_ice, jc.rho_water)
    assert {t.name: int(t) for t in tc.ParticleType} == {t.name: int(t) for t in jc.ParticleType}


@pytest.mark.parametrize("name", PRIMARIES)
@pytest.mark.parametrize("energy", [0.5, 1.0, 1e3, 1e6])
def test_create_cascade_parameters_match(name, energy):
    for medium in ((jc.X0_water, jc.rho_water), (jc.X0_ice, jc.rho_ice)):
        got = tc.createCascadeParameters(getattr(tc, name), energy, *medium)
        want = jc.createCascadeParameters(getattr(jc, name), energy, *medium)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def _particle(module, kind, **kw):
    return module.Particle(module.ParticleType[kind.name], (1.0, -2.0, 0.5), (0.0, 0.6, 0.8), energy=1e3, **kw)


@pytest.mark.parametrize("kind", list(jc.ParticleType), ids=lambda t: t.name)
def test_create_params_from_particle_match(kind):
    for kw in (dict(), dict(length=120.0), dict(length=120.0, uRand=0.3)):
        uRand = kw.pop("uRand", None)
        outs = []
        for module in (jc, tc):
            try:
                cls, params, light_yield = module.createParamsFromParticle(_particle(module, kind, **kw), uRand=uRand)
                outs.append((cls.__name__, params, dataclasses.astuple(light_yield)))
            except ValueError as err:
                outs.append(("raises", str(err).split(" '")[0]))
        assert outs[0] == outs[1], (kind, kw, outs)
    if kind in (jc.ParticleType.E_MINUS, jc.ParticleType.MU_MINUS):
        cls, params, _ = tc.createParamsFromParticle(_particle(tc, kind, length=120.0), lightSourceName="")
        assert cls.__module__ == "theia_tpu_torch.light" and not any("__" in k for k in params)
        cls(**params).params("cpu")  # the port's source takes the parameters as they are
