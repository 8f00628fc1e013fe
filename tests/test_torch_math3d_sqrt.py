"""The port's square root (``theia_tpu_torch.ops.math3d.sqrt``) against
numpy's and JAX's on the CPU: correctly rounded float32 values, and JAX's
gradient rule ``g * (0.5 / sqrt(x))``, bit for bit."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu_torch.ops.math3d import sqrt

torch.set_num_threads(1)

PACKAGE = Path(__file__).resolve().parents[1] / "theia_tpu_torch"


def _values() -> np.ndarray:
    """2048 seeded float32 values over [1e-6, 1e4], log-uniform."""
    rng = np.random.default_rng(2048)
    return np.exp(rng.uniform(np.log(1e-6), np.log(1e4), 2048)).astype(np.float32)


@pytest.mark.parametrize("grad", [False, True], ids=["no grad", "grad"])
def test_sqrt_is_correctly_rounded(grad):
    x = _values()
    t = torch.as_tensor(x).requires_grad_(grad)
    got = sqrt(t).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))


def test_sqrt_gradient_is_jax_rule():
    x = _values()
    t = torch.as_tensor(x).requires_grad_(True)
    sqrt(t).sum().backward()
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.sqrt(a)))(jnp.asarray(x)))
    np.testing.assert_array_equal(t.grad.numpy().view(np.int32), want.view(np.int32))


def test_sqrt_gradient_takes_upstream_gradient():
    x = _values()
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    t = torch.as_tensor(x).requires_grad_(True)
    sqrt(t).backward(torch.as_tensor(g))
    _, vjp = jax.vjp(jnp.sqrt, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_array_equal(t.grad.numpy().view(np.int32), want.view(np.int32))


def test_no_other_square_root_in_the_port():
    """Every lane's square root goes through the helper: no ``torch.sqrt``
    or ``.sqrt()`` outside it, but for a float32 constant and an example's
    optimizer step, which compute no lane's value."""
    allowed = {("response.py", "_SQRT_2PI = "), ("10_geometry_calibration.py", "lr * mh / (torch.sqrt(vh)")}
    found = []
    for path in PACKAGE.rglob("*.py"):
        if path.name == "math3d.py":
            continue
        for line in path.read_text().splitlines():
            if re.search(r"torch\.sqrt\(|\.sqrt\(\)", line):
                if not any(path.name == name and text in line for name, text in allowed):
                    found.append(f"{path.name}: {line.strip()}")
    assert not found, found
