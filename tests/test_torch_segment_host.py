"""The segment kernels' arithmetic on the CPU: ``csrc/segment.cu`` built for
the host with g++ against a stub ``cuda_runtime.h`` (``__global__`` and
``__device__`` empty, ``__ldg`` a load, ``__fdiv_rn`` and ``__fsqrt_rn``
IEEE float division and square root, a launch a loop over the lanes),
held against the plain twins of ``trace/segment.py`` through the same
wrappers and checks that ``chip_smoke.py`` phase 3p runs on the card.

What it holds: every float32 operation of the four kernels and its order,
their masks, selects and Philox dims, on every recorded call of a staged
batch (brute and ``mt``, 2,048 lanes, path length 10), on the edge lanes of
``chip_smoke.segment_edge_lanes`` and through the staged route against the
eager one. What it leaves to the card: the five transcendentals. Host
libm and torch's CPU kernels differ by ulps in log, exp, log1p, sin and
cos, so here both sides take them through float64 (torch's functions are
patched for the test, the stub's ``logf`` and the others are defined so);
on the card the kernels call the libdevice functions that torch's CUDA ops
call (``tests/test_torch_segment_kernels.py -m cuda``, ``chip_smoke.py``).
Tolerance: none, bit for bit (a NaN equal to a NaN).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

import theia_tpu_torch
from theia_tpu_torch import _build
from theia_tpu_torch.trace import segment as seg
from torch_flagship import build_flagship, icosphere

torch.set_num_threads(1)

ENTRY_POINTS = ("theia_segment_pre", "theia_segment_surface", "theia_segment_scatter", "theia_segment_shadow")
#: the launch in csrc/segment.cu that the host build turns into a loop
LAUNCH = "kernel<<<(l->count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(*c, *l);"

STUB = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
using std::isfinite;
#define __global__ static
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct HostIndex { unsigned x, y, z; };
static HostIndex blockIdx, threadIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline int __float_as_int(float f) { int x; std::memcpy(&x, &f, 4); return x; }
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline float __uint2float_rn(unsigned x) { return (float)x; }
inline float host_logf(float x) { return (float)std::log((double)x); }
inline float host_expf(float x) { return (float)std::exp((double)x); }
inline float host_log1pf(float x) { return (float)std::log1p((double)x); }
inline float host_sinf(float x) { return (float)std::sin((double)x); }
inline float host_cosf(float x) { return (float)std::cos((double)x); }
#define logf host_logf
#define expf host_expf
#define log1pf host_log1pf
#define sinf host_sinf
#define cosf host_cosf
"""

LOOP = """{
    for (blockIdx.x = 0; blockIdx.x < (unsigned)((l->count + kThreads - 1) / kThreads); ++blockIdx.x)
      for (threadIdx.x = 0; threadIdx.x < (unsigned)kThreads; ++threadIdx.x) kernel(*c, *l);
  }"""


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """csrc/segment.cu built for the host, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    csrc = Path(theia_tpu_torch.__file__).resolve().parent / "csrc"
    source = (csrc / "segment.cu").read_text()
    assert source.count(LAUNCH) == 1, "the launch of csrc/segment.cu changed: update LAUNCH"
    out = tmp_path_factory.mktemp("segment_host")
    (out / "cuda_runtime.h").write_text(STUB)
    (out / "segment.cpp").write_text('#include "cuda_runtime.h"\n' + source.replace(LAUNCH, LOOP))
    lib = out / "libsegment_host.so"
    cmd = [gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared", f"-I{out}", f"-I{csrc}",
           "-o", str(lib), str(out / "segment.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    loaded = ctypes.CDLL(str(lib))
    for name in ENTRY_POINTS:
        getattr(loaded, name).argtypes = _build._SIGNATURES[name]
        getattr(loaded, name).restype = ctypes.c_int
    return loaded


@pytest.fixture
def host_kernels(host_library, monkeypatch):
    """The wrappers launch the host build on CPU tensors (the twins are
    called by name), and torch's five transcendentals go through float64,
    as the host build's do."""
    monkeypatch.setattr(_build, "library", lambda: host_library)
    monkeypatch.setattr(_build, "raw_stream", lambda t: 0)
    monkeypatch.setattr(seg, "_on_card", lambda s, *tensors: True)
    init = seg.Setup.__init__

    def setup_with_constants(self, *args):
        init(self, *args)
        self.const = seg._const(self)

    monkeypatch.setattr(seg.Setup, "__init__", setup_with_constants)
    for name in ("segment_pre", "segment_surface", "segment_scatter", "segment_shadow"):
        fn = getattr(seg, name)
        monkeypatch.setattr(fn, "launches", fn.launches)  # the host build's launches are not the card's
    for name in ("log", "exp", "log1p", "sin", "cos"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda x, *a, f=real, **k: f(x.double()).float()
                            if x.dtype == torch.float32 else f(x, *a, **k))
    yield


_MESH = {}


def _tracer(accel_name):
    if "m" not in _MESH:
        _MESH["m"] = icosphere(3)
    import chip_smoke

    return build_flagship(theia_tpu_torch, _MESH["m"], 2048, chip_smoke.MAX_PATH, accel=accel_name, device="cpu")


@pytest.mark.parametrize("accel_name", ["auto", "mt"])
def test_host_kernels_equal_twins_on_a_batch(host_kernels, accel_name):
    """Every call of a staged batch: the host build against the twins."""
    import chip_smoke

    calls = chip_smoke.record_segment_calls(_tracer(accel_name))
    assert [n for n, _ in calls[:4]] == list(chip_smoke.SEGMENT_WRAPPERS)
    assert len(calls) == 4 * chip_smoke.MAX_PATH - 2
    compared = sum(chip_smoke.hold_segment_call(name, args)[0] for name, args in calls)
    assert compared == 465


@pytest.mark.parametrize("accel_name", ["auto", "mt"])
def test_host_kernels_equal_twins_on_edge_lanes(host_kernels, accel_name):
    """The edge lanes (total internal reflection, grazing incidence, media
    mismatch, out of the box, past maxTime, dead, NaN and infinite lanes,
    misses), each case met."""
    import chip_smoke

    calls = chip_smoke.record_segment_calls(_tracer(accel_name))
    s, lanes = next(args for name, args in calls if name == "segment_scatter")[:2]
    met = chip_smoke.hold_segment_edges(s, lanes, seed=5)
    assert all(v > 0 for v in met.values()), met


@pytest.mark.parametrize("accel_name", ["auto", "mt"])
def test_host_staged_route_equals_eager(host_kernels, accel_name):
    """The staged route on the host build against the eager segment: the
    light curve, every lane's final dim and each segment's state."""
    import chip_smoke

    out = chip_smoke.segment_routes_equal(accel_name, lambda: _tracer(accel_name))
    assert out["state_arrays"] == 14 * chip_smoke.MAX_PATH and out["light_curve_sum"] > 0.0
    assert seg.segment_shadow.launches > 0


def test_bound_counts_the_bytes_each_kernel_stores(host_kernels):
    """``chip_smoke.segment_bound`` counts the arrays that a kernel stores,
    not its inputs passed through: K_pre 14 B a lane, K_surface 72 (not the
    wavelength or the stream), K_scatter 24 (direction, lin, log, dim) and
    41 for each of the 2N shadow rays, K_shadow 9 a shadow ray (the
    flagship's histogram has no detector axis); its own launch is not
    counted."""
    import chip_smoke

    n = 2048
    want = {"segment_pre": 14 * n, "segment_surface": 72 * n, "segment_scatter": 24 * n + 41 * 2 * n,
            "segment_shadow": 9 * 2 * n}
    calls = chip_smoke.record_segment_calls(_tracer("auto"))
    for name, args in calls[:4]:
        launches = getattr(seg, name).launches
        bound = chip_smoke.segment_bound(name, args)
        assert bound["bound_stored_bytes"] == want[name], (name, bound)
        assert bound["bound_bytes"] > bound["bound_stored_bytes"] and getattr(seg, name).launches == launches


def test_launch_form_matches_the_host_build():
    """The host build rewrites one launch form; every entry point goes
    through it."""
    source = (Path(theia_tpu_torch.__file__).resolve().parent / "csrc" / "segment.cu").read_text()
    assert source.count(LAUNCH) == 1
    entries = re.findall(r'extern "C" int (theia_segment_\w+)\(', source)
    assert tuple(entries) == ENTRY_POINTS
    assert all(f"return launch(segment_{name.split('_')[-1]}, c, l, stream);" in source for name in ENTRY_POINTS)
