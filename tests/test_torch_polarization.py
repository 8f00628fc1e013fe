"""theia_tpu_torch.polarization (and math3d.perpendicular_to2) against
theia_tpu's on random Stokes vectors, frames and directions, including
degenerate frames (a new direction parallel to the old one, a normal
parallel to the ray).

Tolerance: rtol 1e-6 with atol 1e-6. Both packages evaluate the same
float32 formulas; XLA's ``dot`` is a ``sum`` over the last axis and the
port's a left-to-right sum, so results differ by an ulp or two, and the
atol covers components that cancel to ~0 (cos 2phi near 0). A frame
normalized from the cross product of two directions at angle theta
carries ~ulp / sin(theta) of that difference, so the non-parallel pairs
keep theta in [0.5, pi - 0.5] (sin > 0.47); at sin ~ 0.05 the two
packages were measured 4e-6 apart."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu.material as jmat
import theia_tpu.ops.math3d as jm3
import theia_tpu.polarization as jpol
import theia_tpu_torch.material as tmat
import theia_tpu_torch.ops.math3d as tm3
import theia_tpu_torch.polarization as tpol

N = 4096
TOL = dict(rtol=1e-6, atol=1e-6)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _perp(rng, d):
    """Unit vectors perpendicular to each row of ``d``."""
    r = _unit(rng, d.shape[0]).astype(np.float64)
    p = r - (r * d).sum(1, keepdims=True) * d
    return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    d = _unit(rng, N)
    theta = rng.uniform(0.5, np.pi - 0.5, size=(N, 1))
    new_d = (np.cos(theta) * d + np.sin(theta) * _perp(rng, d)).astype(np.float32)
    # every 8th new direction parallel (or anti-parallel) to the old one
    new_d[::8] = d[::8] * np.where(rng.uniform(size=(N // 8, 1)) < 0.5, 1.0, -1.0)
    stokes = np.concatenate(
        [np.ones((N, 1)), rng.uniform(-0.6, 0.6, size=(N, 3))], axis=1
    ).astype(np.float32)
    return dict(
        d=d, new_d=new_d, ref=_perp(rng, d), new_ref=_perp(rng, d), stokes=stokes,
        c=rng.uniform(-1, 1, N).astype(np.float32), s=rng.uniform(-1, 1, N).astype(np.float32),
        m=rng.uniform(-1, 1, size=(4, N)).astype(np.float32),
        p=rng.uniform(-1, 1, N).astype(np.float32), q=rng.uniform(-1, 1, N).astype(np.float32),
        cos=rng.uniform(-1, 1, N).astype(np.float32),
    )


def _both(fn_name, *args, module="pol"):
    jfn = getattr(jm3 if module == "m3" else jpol, fn_name)
    tfn = getattr(tm3 if module == "m3" else tpol, fn_name)
    want = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(torch.as_tensor(a) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _close(fn_name, *args, module="pol"):
    for w, g in zip(*_both(fn_name, *args, module=module)):
        assert w.shape == g.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL, err_msg=fn_name)


def test_frames(data):
    d = data
    _close("rotation_coeffs", d["d"], d["ref"], d["new_ref"])
    _close("align_pol_ref", d["d"], d["ref"], d["new_ref"])
    _close("rotate_pol_ref", d["d"], d["ref"], d["new_d"])
    new_ref, c, s = tpol.rotate_pol_ref(*(torch.as_tensor(d[k]) for k in ("d", "ref", "new_d")))
    # parallel directions keep the frame with the identity rotation
    assert torch.equal(new_ref[::8], torch.as_tensor(d["ref"][::8]))
    assert (c[::8] == 1.0).all() and (s[::8] == 0.0).all()


def test_perpendicular_to2(data):
    a, b = data["d"], data["new_d"]  # every 8th pair parallel
    _close("perpendicular_to2", a, b, module="m3")
    got = tm3.perpendicular_to2(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose((got * a).sum(1), 0.0, atol=1e-6)


def test_stokes_operators(data):
    d = data
    _close("apply_rotation", d["stokes"], d["c"], d["s"])
    _close("apply_phase_matrix", d["stokes"], *d["m"])
    _close("polarizer_coeffs", d["p"], d["q"])
    _close("polarizer_coeffs", d["p"], np.zeros_like(d["p"]))  # s = 0
    _close("polarizer_coeffs", np.zeros_like(d["p"]), np.zeros_like(d["q"]))  # att = 0
    _close("apply_polarizer", d["stokes"], d["m"][0], d["m"][2])
    np.testing.assert_array_equal(
        tpol.unpolarized_stokes((3, 5)).numpy(), np.asarray(jpol.unpolarized_stokes((3, 5)))
    )


def test_mueller_forms(data):
    d = data
    _close("rotation_mueller", d["c"], d["s"])
    _close("phase_mueller", *d["m"])
    _close("polarizer_mueller", d["m"][0], d["m"][2])
    # the Mueller forms act as their Stokes operators
    stokes = torch.as_tensor(d["stokes"])
    m = [torch.as_tensor(x) for x in d["m"]]
    via_matrix = (tpol.phase_mueller(*m) @ stokes[..., None])[..., 0]
    torch.testing.assert_close(via_matrix, tpol.apply_phase_matrix(stokes, *m), **TOL)


def test_phase_matrix_elements(data):
    """A null medium (identity), a medium with null tables (depolarizer)
    and one with tables, read at random scattering angles."""
    rng = np.random.default_rng(3)
    tables = {f"phase_{k}": rng.uniform(-1, 1, 33).astype(np.float32) for k in ("m12", "m22", "m33", "m34")}
    cos = data["cos"]
    cases = [
        (None, None),
        (jmat.Medium(300.0, 700.0), tmat.Medium(300.0, 700.0)),
        (jmat.Medium(300.0, 700.0, **tables), tmat.Medium(300.0, 700.0, **tables)),
    ]
    for jm, tm in cases:
        want = jpol.phase_matrix_elements(jm, jnp.asarray(cos))
        got = tpol.phase_matrix_elements(tm, torch.as_tensor(cos))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
