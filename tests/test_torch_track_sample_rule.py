"""The one-pass rule of the track's backward-sample kernel
(``csrc/cherenkov_track.cu``), mirrored here on the CPU, against the plain
version (``ops.cherenkov_track.track_backward_sample_plain``) and against
``theia_tpu``'s ``CherenkovTrackLightSource.sample_backward``.

The rule: a pair off the segment adds a zero to a tame lane's running sum
(tame: the row's and the lane's magnitudes within ``TAME_*``), so the
kernel's one pass only tests each pair (mu, d_perp, the shift, the segment
test) and lists the lane's segments on the segment, up to ``TRACK_LIST``;
the listed pairs, formed whole in segment order, give total and the
running sums after each, and k counts, over the runs between listed
segments, those whose running sum is below u total. A lane that is not
tame, lists more than ``TRACK_LIST`` segments, or meets a row that is not
tame, takes the plain two passes over every segment.

Tolerances and why: the mirror forms the same float32 sums in the same
order as the plain version, so total is held bit for bit (NaN equal to
NaN) and k exactly. Against ``theia_tpu`` the test of
``tests/test_torch_cherenkov.py::test_track_backward_sample`` applies: the
total within rtol 1e-5 (JAX sums the segments in its own association),
the chosen candidate the same wherever no running sum lies within 1e-5 of
u total, at most 1 % of the lit lanes apart.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import theia_tpu.light as jlight
import theia_tpu.material as jmaterial
from theia_tpu_torch import light as tlight, material as tmaterial
from theia_tpu_torch.ops import cherenkov_track as ct
from theia_tpu_torch.ops.math3d import dot

torch.set_num_threads(1)

N = 4096
CSRC = Path(ct.__file__).resolve().parents[1] / "csrc" / "cherenkov_track.cu"


def rule_cases():
    """``chip_smoke.track_rule_cases`` (the edge lanes, equal running sums,
    the zigzags of 300 segments, a row that is not tame) and the bent line
    of ``chip_smoke.track_case`` at 256 segments, ``N`` lanes each."""
    if not hasattr(rule_cases, "cached"):
        cases = chip_smoke.track_rule_cases(N, "cpu")
        cases["bent line, 256 segments"] = chip_smoke.track_case(N, 256, 11, "cpu")
        rule_cases.cached = cases
    return rule_cases.cached


def tame_lanes(observer, normal, ft, cot):
    """The kernel's ``tame_lane``: float32 compares with its constants."""
    n1 = (normal[:, 0].abs() + normal[:, 1].abs()) + normal[:, 2].abs()
    f = ft.abs()
    w = ct.TAME_WEIGHT
    return ((observer.abs() <= ct.TAME_POSITION).all(1) & (cot.abs() <= ct.TAME_COT) & (f <= w) & (n1 <= w)
            & (torch.clamp_min(f, 1.0) * torch.clamp_min(n1, 1.0) <= w))


def tame_rows(seg):
    """The kernel's test of a row in ``load_tile``."""
    return (seg[:, 0:3].abs() <= ct.TAME_POSITION).all(1) & (seg[:, 5:8].abs() <= ct.TAME_DIRECTION).all(1)


def pairs(seg, observer, normal, ft, cot):
    """(S, N) of every pair: on the segment, and its full contribution (the
    plain version's ``_candidate`` and ``_contrib``)."""
    is_zero = dot(normal, normal) == 0.0
    on, contrib = [], []
    for s in range(seg.shape[0]):
        cand = ct._candidate(seg[s], observer, cot)
        on.append((cand[4] >= 0.0) & (cand[4] <= cand[5]))
        contrib.append(ct._contrib(cand, normal, is_zero, ft))
    return torch.stack(on), torch.stack(contrib)


def mirror(seg, observer, normal, ft, cot, u, m: int = ct.TRACK_LIST):
    """The kernel's rule with a list of ``m``: a dict of total, k, the lanes
    of the second pass (``slow``), each lane's lit count, whether a listed
    running sum met u total exactly (``tie``), and the pairs."""
    n, segments = observer.shape[0], seg.shape[0]
    on, contrib = pairs(seg, observer, normal, ft, cot)
    count = on.sum(0)
    wild_table = not bool(tame_rows(seg).all())
    slow = ~tame_lanes(observer, normal, ft, cot) | (count > m) | wild_table
    lanes = torch.arange(n)
    # the pass: each lane's first m segments on the segment, in order
    listed = torch.full((m, n), segments, dtype=torch.int64)
    filled = torch.zeros(n, dtype=torch.int64)
    for s in range(segments):
        take = on[s] & (filled < m)
        listed[filled[take], lanes[take]] = s
        filled += on[s]
    # the listed pairs whole: total and the running sum after each
    total = torch.zeros(n)
    running = torch.zeros((m, n))
    for j in range(m):
        c = contrib[listed[j].clamp_max(segments - 1), lanes]
        total = torch.where(j < count, total + c, total)
        running[j] = total
    thresh = u * total
    # k over the runs between listed segments, +0 before the first
    k = torch.zeros(n, dtype=torch.int64)
    cum, start = torch.zeros(n), torch.zeros(n, dtype=torch.int64)
    tie = torch.zeros(n, dtype=torch.bool)
    for j in range(m):
        has = j < count
        k += torch.where(has, (listed[j] - start) * (cum < thresh), 0)
        cum, start = torch.where(has, running[j], cum), torch.where(has, listed[j], start)
        tie |= has & (running[j] == thresh)
    k += (segments - start) * (cum < thresh)
    # the second pass: the full form of every pair, summed, then counted
    full = torch.zeros(n)
    for s in range(segments):
        full = full + contrib[s]
    full_thresh, cum, count_below = u * full, torch.zeros(n), torch.zeros(n, dtype=torch.int64)
    for s in range(segments):
        cum = cum + contrib[s]
        count_below += cum < full_thresh
    total = torch.where(slow, full, total)
    k = torch.clamp_max(torch.where(slow, count_below, k), segments - 1).to(torch.int32)
    return dict(total=total, k=k, slow=slow, count=count, tie=tie & ~slow, on=on, contrib=contrib)


def same_bits(a, b) -> bool:
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


@pytest.mark.parametrize("m", [ct.TRACK_LIST, 2])
@pytest.mark.parametrize("case", ["edge lanes", "equal running sums", "zigzag, 300 segments",
                                  "dense zigzag, 300 segments", "a wild row", "bent line, 256 segments"])
def test_rule_matches_plain(case, m):
    """The mirror's total and k against the plain version's, bit for bit,
    with the kernel's list and with a list of 2 (more lanes overflow it);
    each case singles out what it claims to."""
    args = rule_cases()[case]
    got = mirror(*args, m=m)
    with torch.no_grad():
        total, *_, k = ct.track_backward_sample_plain(*args)
    assert same_bits(got["total"], total), case
    assert torch.equal(got["k"], k), (case, int((got["k"] != k).sum()))
    fast, count = ~got["slow"], got["count"]
    print(f"{case}, list of {m}: {int(got['slow'].sum())} of {N} lanes take the second pass; lit segments a lane "
          f"{int(count.min())}-{int(count.max())}, mean {float(count.double().mean()):.2f}; "
          f"{int(got['tie'].sum())} listed running sums at u total")
    if case == "a wild row":
        assert bool(got["slow"].all())
    elif case == "zigzag, 300 segments":  # many lit segments a lane, all within the kernel's list
        assert bool((count > 8).any()) and not bool((count > ct.TRACK_LIST).any())
    elif case == "dense zigzag, 300 segments":  # lanes on either side of the kernel's list
        assert bool(((count > 8) & (count <= ct.TRACK_LIST)).any()) and int((count > ct.TRACK_LIST).sum()) > N // 4
    elif case == "equal running sums":
        assert int(got["tie"].sum()) > N // 10, "no running sum met u total"
    elif case == "edge lanes":
        lane = {label: j for j, label in enumerate(chip_smoke.TRACK_EDGE_LANES)}
        for label in ("ft NaN", "observer +inf", "observer -inf", "normal NaN", "cot NaN", "cot 1e8 (not tame)"):
            assert bool(got["slow"][lane[label]]), label
        for label in ("u 0", "u 1 - 2^-24", "u 1", "u NaN", "ft 0", "observer at TAME_POSITION", "ft at TAME_WEIGHT"):
            assert not bool(got["slow"][lane[label]]), label
        assert bool(torch.isnan(total[lane["ft NaN"]])) and int(k[lane["u NaN"]]) == 0
        assert float(total[lane["on the line past its end (total 0)"]]) == 0.0
        facing = lane["a surface facing away"]
        assert float(total[facing]) == 0.0 and int(count[facing]) > 0, "the facing-away lane is not lit"
        assert float(total[lane["u 1"]]) > 0.0 and bool(fast.any())


@pytest.mark.parametrize("case", ["edge lanes", "equal running sums", "dense zigzag, 300 segments",
                                  "bent line, 256 segments", "at the bounds"])
def test_off_segment_pairs_of_tame_lanes_add_zero(case):
    """The short form's premise: every pair off the segment of a tame lane
    on tame rows contributes a zero (+0, or -0 where ft < 0). "at the
    bounds" puts observers, rows, cotangents, weights and normals at and
    near the tame limits, where an intermediate could overflow."""
    args = bounds_case() if case == "at the bounds" else rule_cases()[case]
    seg, observer, normal, ft, cot, _ = args
    on, contrib = pairs(seg, observer, normal, ft, cot)
    tame = tame_lanes(observer, normal, ft, cot)[None, :] & tame_rows(seg)[:, None]
    off = tame & ~on
    assert int(off.sum()) > 0
    bad = off & (contrib != 0.0)
    assert not bool(bad.any()), f"{int(bad.sum())} off-segment pairs of tame lanes add {contrib[bad][:5].tolist()}"


def bounds_case():
    """Rows and lanes at the tame limits (seeded numpy): starts and
    observers at up to 1e15 in each coordinate, unnormalised directions of
    up to 2 a coordinate, cotangents of up to 1e7, |ft| up to 1e20 with
    the normal's L1 norm at 1e20 / max(|ft|, 1), every sign."""
    rs = np.random.default_rng(12)
    s, n = 64, N
    big = lambda shape: rs.choice([-1.0, 1.0], shape) * 10.0 ** rs.uniform(-3.0, 15.0, shape)
    seg = np.zeros((s, 9), np.float32)
    seg[:, 0:3] = big((s, 3))
    seg[:, 5:8] = rs.uniform(-2.0, 2.0, (s, 3))
    seg[:, 8] = 10.0 ** rs.uniform(-3.0, 16.0, s)
    observer = big((n, 3)).astype(np.float32)
    observer[:8] = np.float32(1e15) * rs.choice([-1.0, 1.0], (8, 3))
    ft = (rs.choice([-1.0, 1.0], n) * 10.0 ** rs.uniform(-5.0, 20.0, n)).astype(np.float32)
    normal = rs.normal(size=(n, 3))
    normal *= (1e20 / np.maximum(np.abs(ft), 1.0) / np.abs(normal).sum(1) * rs.uniform(0.1, 0.999, n))[:, None]
    normal[: n // 4] = 0.0
    cot = (rs.choice([-1.0, 1.0], n) * 10.0 ** rs.uniform(-3.0, 7.0, n)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return t(seg), t(observer), t(normal), t(ft), t(cot), t(rs.uniform(size=n))


class _FixedUniform:
    """An RNG state whose one draw is the given uniforms (what
    ``sample_backward`` draws for k), so that u takes any value."""

    def __init__(self, u):
        self.u = u

    def uniform(self):
        return self.u, self


def _light(light, verts):
    return light.CherenkovTrackLightSource(light.ParticleTrack(verts), usePhotonCount=True)


def jax_comparison_case(kind: str):
    """(vertices, observers, normals, n, wavelengths, u) as numpy: the bent
    line at 256 segments or the zigzag at 300, half of the lanes on a
    surface, u from the seeded draw with 0, 1 - 2^-24 and 1 in its first
    lanes."""
    rs = np.random.default_rng(13)
    if kind == "bent line, 256 segments":
        x = np.linspace(-50.0, 50.0, 257)
        verts = np.stack([x, np.where(x > 0, 0.3 * x, 0.0), 0 * x, x / 0.3], axis=1)
        obs = rs.uniform(-60.0, 60.0, (N, 3))
    else:
        verts, obs = chip_smoke.zigzag(N, rs)
    nrm = rs.normal(size=(N, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[: N // 2] = 0.0
    u = rs.uniform(size=N)
    u[:3] = (0.0, 1.0 - 2.0**-24, 1.0)
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(verts), f32(obs), f32(nrm), f32(rs.uniform(1.33, 1.36, N)), f32(rs.uniform(420.0, 480.0, N)), f32(u)


@pytest.mark.parametrize("case", ["bent line, 256 segments", "zigzag, 300 segments"])
def test_rule_matches_jax(case, monkeypatch):
    """The mirror on the arguments that the port's ``sample_backward``
    passes to ``track_backward_sample``, against ``theia_tpu``'s
    ``sample_backward`` on the same inputs and uniforms: the total, and
    the chosen candidate's position but near a tie of a running sum with
    u total."""
    verts, obs, nrm, n_refr, lam, u = jax_comparison_case(case)
    jn = jnp.asarray(n_refr)
    jconst = jmaterial.MediumConstants(n=jn, vg=jn * 0 + 0.22, mu_s=jn * 0, mu_e=jn * 0)
    jray, _ = _light(jlight, verts).sample_backward(
        {"track": jnp.asarray(verts)}, jnp.asarray(obs), jnp.asarray(nrm), jnp.asarray(lam), jconst,
        _FixedUniform(jnp.asarray(u)))
    seen = []
    real = ct.track_backward_sample
    monkeypatch.setattr(ct, "track_backward_sample", lambda *a: seen.append(a) or real(*a))
    tn = torch.as_tensor(n_refr)
    tconst = tmaterial.MediumConstants(n=tn, vg=tn * 0 + 0.22, mu_s=tn * 0, mu_e=tn * 0)
    source = _light(tlight, verts)
    tray, _ = source.sample_backward(source.params("cpu"), torch.as_tensor(obs), torch.as_tensor(nrm),
                                     torch.as_tensor(lam), tconst, _FixedUniform(torch.as_tensor(u)))
    (args,) = seen
    got = mirror(*args)
    total, k = got["total"].numpy(), got["k"].numpy()
    jtotal = np.asarray(jray.contrib)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5, atol=1e-6 * np.abs(jtotal).max())
    assert np.array_equal(total, tray.contrib.numpy()) and int(k[0]) == 0
    position = ct._chosen(args[0], got["k"].long(), args[1], args[4])[0].numpy()
    contrib = got["contrib"].double().numpy()
    cum = np.cumsum(contrib, axis=0)
    thresh = u.astype(np.float64) * contrib.sum(0)
    near = (np.abs(cum - thresh) <= 1e-5 * np.maximum(np.abs(thresh), 1e-30)).any(0)
    live = total > 0
    moved = (np.abs(position - np.asarray(jray.position)).max(1) > 1e-4 * np.abs(position).max()) & live
    print(f"{case}: {int(live.sum())} lit lanes, {int(got['slow'].sum())} past the list, the sample moved from "
          f"theia_tpu's on {int(moved.sum())}, {int((near & live).sum())} near a tie")
    assert not (moved & ~near).any() and moved.mean() <= 0.01


def test_kernel_constants_match():
    """The list's length and the tame bounds are the kernel's."""
    text = CSRC.read_text()
    number = lambda name: float(re.search(rf"{name}\s*=?\s*([0-9.e+-]+)f?;?", text).group(1))
    assert int(re.search(r"constexpr int kList = (\d+);", text).group(1)) == ct.TRACK_LIST
    assert (number("kTamePosition"), number("kTameDirection"), number("kTameCot"), number("kTameWeight")) == (
        ct.TAME_POSITION, ct.TAME_DIRECTION, ct.TAME_COT, ct.TAME_WEIGHT)
