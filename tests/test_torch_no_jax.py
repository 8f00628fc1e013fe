"""theia_tpu_torch must run without jax: importing it and tracing a small
flagship batch of each backend in a fresh interpreter leaves jax and theia_tpu unloaded."""

import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent

SCRIPT = f"""
import sys
sys.path.insert(0, {str(TESTS)!r})
sys.path.insert(0, {str(TESTS.parent)!r})
import theia_tpu_torch
import theia_tpu_torch.ops.intersect_woop
import theia_tpu_torch.ops.intersect_soup
import theia_tpu_torch.polarization
from torch_flagship import build_flagship, icosphere
tracer = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, device="cpu")
hist, _ = tracer.run()
assert hist.shape == (100,)
tracer = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="woop", device="cpu", polarized=True)
hist, _ = tracer.run()
assert hist.shape == (100,)
tracer = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="auto", device="cpu")
assert tracer.scene.accel == "brute" and tracer.scene.pack.cull is not None
hist, _ = tracer.run()
assert hist.shape == (100,)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "theia_tpu"))
print("LOADED", loaded)
"""


def test_port_never_imports_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
