"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA device and nvcc; without them they skip. On a machine
with a card: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
``chip_smoke.py`` runs the same comparisons at the main path's shapes and
lends its helpers: run ``python -m pytest`` from the repository root, which
puts ``chip_smoke.py`` on the path."""

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


def _rays(n, seed, cuda):
    rng = np.random.default_rng(seed)
    o = torch.as_tensor(rng.uniform(-1, 4, (n, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(
        torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=cuda), dim=1
    )
    tmax = torch.as_tensor(
        np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.5, 5.0, n), np.inf).astype(np.float32),
        device=cuda,
    )
    return o, d, tmax


def test_woop_kernel_bit_equal(cuda):
    """3840 triangles fill 7.5 tiles of 512: the last tile is half padding."""
    import theia_tpu_torch
    from theia_tpu_torch.ops.intersect_woop import WoopPack, nearest_triangle_woop, nearest_triangle_woop_plain
    from torch_flagship import build_flagship, icosphere

    pack = build_flagship(theia_tpu_torch, icosphere(3), 64, 2, accel="woop", device=cuda).scene.pack.woop
    cpu_pack = WoopPack(pack.b.cpu(), pack.aabb, pack.lo, pack.hi, pack.n_tri, pack.chunk_box.cpu(), pack.sub_box.cpu())
    o, d, tmax = _rays(10_000, 1, cuda)
    before = nearest_triangle_woop.launches
    t, i = nearest_triangle_woop(pack, o, d, tmax)
    torch.cuda.synchronize()
    assert nearest_triangle_woop.launches == before + 1
    t_p, i_p = nearest_triangle_woop_plain(cpu_pack, o.cpu(), d.cpu(), tmax.cpu())
    assert (i_p >= 0).any()
    assert torch.equal(i.cpu(), i_p) and torch.equal(t.cpu(), t_p)


def test_mt_rows_kernel_bit_equal(cuda):
    import theia_tpu_torch
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows
    from torch_flagship import build_flagship, icosphere

    pack = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, device=cuda).scene.pack
    o, d, tmax = _rays(10_000, 2, cuda)
    t, i, rows = nearest_triangle_mt_rows(pack.mt, pack.tri_data, o, d, tmax)
    t_a, i_a = nearest_triangle_mt(pack.mt, o, d, tmax)
    torch.cuda.synchronize()
    assert torch.equal(t, t_a) and torch.equal(i, i_a)
    assert torch.equal(rows, pack.tri_data[torch.clamp_min(i_a, 0).long()])


def test_histogram_grad_kernel_bit_exact(cuda):
    from theia_tpu_torch.response import histogram_grad, histogram_grad_plain

    rng = np.random.default_rng(4)
    n, bins, det = 20_000, 50, 3
    args = [
        torch.as_tensor(rng.uniform(-5, 260, n).astype(np.float32)),
        torch.as_tensor(rng.uniform(size=n) < 0.6),
        torch.tensor(0.0),
        torch.tensor(5.0),
    ]
    oid = torch.as_tensor(rng.integers(-1, det + 1, n).astype(np.int32))
    grad_state = torch.as_tensor(rng.normal(size=bins * det).astype(np.float32))
    want = histogram_grad_plain(grad_state, *args, bins, oid, det)
    got = histogram_grad(grad_state.to(cuda), *(a.to(cuda) for a in args), bins, oid.to(cuda), det)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["nearest_triangle_mt", "nearest_triangle_mt_rows", "nearest_triangle_woop"])
def test_nearest_kernels_on_hard_rays(cuda, name):
    """The three nearest-hit entry points against their plain versions, bit
    for bit, where a wrong rejection would show: adversarial rays (through
    vertices, along edges, in a triangle's plane, off a surface, with NaN
    and huge rays among them) and every query of one recorded flagship
    batch (batch 8192, path length 4). The batch's records go through the
    histogram kernels the same way."""
    import chip_smoke
    import theia_tpu_torch
    from torch_flagship import adversarial_rays, build_flagship, icosphere

    woop = name == "nearest_triangle_woop"
    kw = dict(accel="woop", polarized=True) if woop else {}
    tracer = build_flagship(theia_tpu_torch, icosphere(3), 8192, 4, device=cuda, **kw)
    nearest = chip_smoke.Nearest(name, tracer.scene.pack)
    rows = tracer.scene.pack.tri_data[:, 18:27].cpu().numpy()
    o, d = adversarial_rays(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], seed=3, per_kind=256)
    o[5], d[6], o[7] = np.nan, np.inf, 3e38
    hard = (torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda),
            torch.full((o.shape[0],), float("inf"), device=cuda))
    before = nearest.kernel.launches
    _, hits = nearest.check(hard, "adversarial rays", on_cpu=True)
    assert nearest.kernel.launches == before + 1 and hits > 0.5
    queries = chip_smoke.record_queries(
        tracer, ("nearest_triangle_woop" if woop else "nearest_triangle_mt_rows",)
    )
    assert len(queries) == 7
    records = chip_smoke.record_records(tracer)
    # polarized runs record unfused, as theia_tpu's: the extension and the
    # surface record every segment, the two shadow halves all but the last
    assert len(records) == (14 if woop else 7)
    for k, record in enumerate(records):
        chip_smoke.hold_record(record, f"record {k} of a flagship batch")
    for q in queries:
        nearest.check(q, "a recorded flagship query", on_cpu=False)
        # with t_max at the hit, that hit no longer counts
        t_hit = nearest.run(nearest.kernel, nearest.pack, q)[0]
        nearest.check((q[0], q[1], t_hit.contiguous()), "t_max at the hit", on_cpu=False)


#: arguments of ``chip_smoke.hist_case``: the sizes, states and alignments
#: of the CPU tests of the record, and the states that take the record's
#: other code paths on the card
HIST_CASES = {
    "n1": dict(n=1, kept=1.0),
    "n3": dict(n=3),
    "n5": dict(n=5),
    "n1023": dict(n=1023),
    "n4099": dict(n=4099),
    "detector_axis": dict(n=4099, bins=50, n_det=3),
    "above_1024_bins": dict(n=4099, bins=600, n_det=3),
    "views_at_element_1": dict(n=20_001, offset=1),  # the bool mask starts at an odd byte
    "views_at_element_3_detector_axis": dict(n=20_002, bins=50, n_det=3, offset=3),
    "state_of_200_KB": dict(n=20_000, bins=1000, n_det=50),
    "large_state": dict(n=20_000, bins=1000, n_det=64),
    "large_state_views_at_element_1": dict(n=20_001, bins=1000, n_det=64, offset=1),
    "large_state_all_kept": dict(n=20_000, bins=1000, n_det=64, kept=1.0),
}


@pytest.mark.parametrize("name", sorted(HIST_CASES))
def test_histogram_kernels_on_cases(cuda, name):
    """The record (rtol 1e-4 a bin: atomic order) and its backward (bit for
    bit) against their plain versions, with times on exact bin edges, NaN
    and infinite times among the lanes."""
    import chip_smoke
    from theia_tpu_torch.response import SHARED_STATE_MAX, histogram_add, histogram_grad

    kw = HIST_CASES[name]
    value, time, mask, t0, bin_size, bins, oid, n_det = chip_smoke.hist_case(seed=len(name), **kw)
    assert (bins * (n_det or 1) > SHARED_STATE_MAX) == name.startswith("large_state")
    assert value.data_ptr() % 16 == 4 * kw.get("offset", 0) and mask.data_ptr() % 4 == kw.get("offset", 0)
    lane = torch.arange(time.shape[0], device=cuda)
    time[lane % 7 == 1] = 5.0 * (lane[lane % 7 == 1] % (bins + 3) - 1).float()  # edges, from below t0 to past the end
    time[lane % 11 == 3] = float("nan")
    time[lane % 13 == 5] = float("inf")
    time[lane % 17 == 7] = float("-inf")
    before = histogram_add.launches, histogram_grad.launches
    chip_smoke.hold_record((value, time, mask, t0, bin_size, bins, oid, n_det), name)
    assert (histogram_add.launches, histogram_grad.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("name", ["n4099", "views_at_element_1", "large_state", "large_state_views_at_element_1"])
def test_histogram_all_masked_leaves_state(cuda, name):
    """A record whose lanes are all masked, or all out of range, leaves the
    state bit-equal, and its backward is zero."""
    import chip_smoke
    from theia_tpu_torch.response import histogram_add, histogram_grad

    value, time, mask, *rest = chip_smoke.hist_case(seed=1, **HIST_CASES[name])
    state = torch.rand(rest[2] * (rest[4] or 1), device=cuda) + 1.0
    want = state.clone()
    nowhere = torch.full_like(time, float("nan"))
    for t, m in ((time, torch.zeros_like(mask)), (nowhere, mask), (-1.0 - time.abs(), mask)):
        histogram_add(state, value, t, m, *rest)
        torch.cuda.synchronize()
        assert torch.equal(state, want)
        assert not histogram_grad(state, t, m, *rest).any()


@pytest.mark.parametrize("name", ["nearest_in_table", "nearest_in_table_rows", "anyhit_in_table", "target_in_table"])
def test_soup_kernels_on_hard_rays(cuda, name):
    """The four soup entry points against their plain versions, bit for
    bit: adversarial rays (NaN and huge rays among them) over all groups
    and over the detector or the occluders with a lane mask, groups that
    end inside a chunk, and every query of one recorded brute-force
    flagship batch (batch 8192, path length 4) with the groups, bounds and
    masks the tracer passed (the any-hit on the occluder halves of its
    shadow pairs); then with the bound at the hit."""
    import chip_smoke
    import theia_tpu_torch
    from theia_tpu_torch.ops.intersect_soup import SoupTable, nearest_in_table
    from torch_flagship import adversarial_rays, build_flagship, icosphere

    tracer = build_flagship(theia_tpu_torch, icosphere(3), 8192, 4, accel="auto", device=cuda)
    pack = tracer.scene.pack
    soup = chip_smoke.Soup(name, pack)
    rows = pack.tri_data[:, 18:27].cpu().numpy()
    o, d = adversarial_rays(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], seed=3, per_kind=256)
    o[5], d[6], o[7] = np.nan, np.inf, 3e38
    hard = (torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda),
            torch.full((o.shape[0],), float("inf"), device=cuda))
    active = torch.as_tensor(np.random.default_rng(1).uniform(size=o.shape[0]) < 0.5, device=cuda)
    before = soup.kernel.launches
    hits = soup.check(hard, "adversarial rays", on_cpu=True)
    # a shadow pair answers on the detector's third of the soup alone
    assert soup.kernel.launches == before + 1 and hits > (0.1 if soup.target else 0.5)
    for groups in ([2], [0, 1]):
        soup.check(hard, f"adversarial rays, groups {groups}, masked", on_cpu=True, groups=groups, active=active)
    odd = SoupTable(pack.w_v0, pack.w_e1, pack.w_e2, ((0, 100), (100, 100), (100, 1000), (1000, 2561), (2561, 3840)))
    for groups in (None, [0, 2], [1]):
        soup.check(hard, f"oddly cut groups {groups}", on_cpu=True, groups=groups, active=active,
                   tables=(odd, odd.to("cpu")))
    # 4 primary queries (every group, no mask) and 3 shadow pairs
    primary = chip_smoke.record_soup_queries(tracer, "nearest_in_table_rows")
    shadow = chip_smoke.record_soup_queries(tracer, "target_in_table")
    assert len(primary) == 4 and all(groups is None and mask is None for *_, groups, mask in primary)
    assert len(shadow) == 3 and all(groups == [2] and mask is not None for *_, groups, mask in shadow)
    queries = primary + shadow
    if soup.target:
        queries = shadow
    elif soup.any_hit:  # the occluder halves: bounded by the detector's hit, on the lanes that found one
        queries = []
        for q_o, q_d, t_max, groups, mask in shadow:
            t_det, idx_det = nearest_in_table(soup.tables[0], q_o, q_d, t_max, groups=groups, active=mask)
            queries.append((q_o, q_d, t_det, [0, 1], idx_det >= 0))
    for q_o, q_d, t_max, groups, mask in queries:
        soup.check((q_o, q_d, t_max), "a recorded flagship query", on_cpu=False, groups=groups, active=mask)
        # with the bound at the nearest hit, that hit no longer counts
        t_hit = nearest_in_table(soup.tables[0], q_o, q_d, t_max, groups=groups, active=mask)[0]
        soup.check((q_o, q_d, t_hit.contiguous()), "the bound at the hit", on_cpu=False, groups=groups, active=mask)


@pytest.mark.parametrize(
    "label,args",
    [
        ("N=20000", dict(n=20_000, seed=1)),
        ("odd N with a detector axis", dict(n=4099, seed=2, bins=50, n_det=3)),
        ("views at element 1", dict(n=1001, seed=3, offset=1)),
        ("a state past shared memory", dict(n=5000, seed=4, bins=1000, n_det=64)),
    ],
)
def test_kernel_histogram_kernels(cuda, label, args):
    """The kernel histogram's record and backward (``csrc/kernel_histogram.cu``)
    against their plain versions, under ``chip_smoke.hold_kde``'s stated
    tolerances."""
    from chip_smoke import hold_kde, kde_case
    from theia_tpu_torch.response import kernel_histogram_add, kernel_histogram_grad

    before = kernel_histogram_add.launches, kernel_histogram_grad.launches
    hold_kde(kde_case(**args), label)
    assert (kernel_histogram_add.launches, kernel_histogram_grad.launches) == (before[0] + 1, before[1] + 1)


def test_table_read_kernels(cuda):
    """The table reads (``csrc/table_read.cu``), every form of every read
    site, on the flagship scene's tables and the volume flagship's medium
    against their plain versions, under ``chip_smoke.hold_table_reads``'
    stated tolerances."""
    import theia_tpu_torch
    from chip_smoke import hold_table_reads
    from theia_tpu_torch.ops import table_read
    from torch_flagship import build_flagship, build_volume_flagship, icosphere

    store = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="auto", device=cuda).scene.pack.media
    medium = build_volume_flagship(theia_tpu_torch, 64, cuda).params()["medium"]
    before = table_read.read_packed.launches
    hold_table_reads(store, medium)
    assert table_read.read_packed.launches > before and table_read.read_table_grad.launches > 0


def test_gather_rows_kernels(cuda):
    """The hit reconstruction's row gathers and their backward
    (``csrc/table_read.cu``), with the reconstruction's spans and as whole
    rows, on the brute flagship's ``tri_data`` (the backward in device
    memory) and ``inst_data`` (in shared memory), with winners drawn at
    random (-1 on a miss), and on ragged, unaligned and narrow tables,
    under ``chip_smoke.check_gather_rows``' stated tolerances."""
    import theia_tpu_torch
    from chip_smoke import BATCH, check_gather_rows
    from theia_tpu_torch.ops.table_read import gather_rows, gather_rows_grad
    from torch_flagship import build_flagship, icosphere

    pack = build_flagship(theia_tpu_torch, icosphere(3), 64, 2, accel="auto", device=cuda).scene.pack
    rng = np.random.default_rng(3)
    rows = np.where(rng.uniform(size=BATCH) < 0.5, rng.integers(0, pack.tri_data.shape[0], BATCH), -1)
    winners = torch.as_tensor(rows.astype(np.int32), device=cuda)
    before = gather_rows.launches, gather_rows_grad.launches
    check_gather_rows({}, {}, pack, winners)
    assert gather_rows.launches > before[0] and gather_rows_grad.launches > before[1]


#: chip_smoke.read_cases' labels: every form of every read site
READ_CASES = [
    "read_packed", "read_packed, fresnel", "read_packed, scatter prob", "read_packed, phase matrix",
    "read_packed, const4", "read_table", "read_table, phase", "read_table, medium constants",
    "read_table, phase matrix",
]


@pytest.mark.parametrize("traffic", ["lanes spread", "every lane at one coordinate", "most lanes dead"])
@pytest.mark.parametrize("name", READ_CASES)
def test_table_read_backward_kernel(cuda, name, traffic):
    """The table reads' backward (``read_tables_grad``: a block's shared
    copy of the tables' gradients) on each
    read case of ``chip_smoke.read_cases``, with every lane at one
    coordinate and with upstream gradients nonzero on
    ``chip_smoke.READ_LIVE_SHARE`` of the lanes, under
    ``chip_smoke.hold_read_grad``: d x bit-equal to the plain version, the
    tables' gradients within 2e-5 of their absolute sums; one launch a
    backward."""
    import theia_tpu_torch
    from chip_smoke import HOT, LIVE, READ_LIVE_SHARE, hold_read_grad, hot_read_case, read_cases
    from theia_tpu_torch.ops import table_read
    from torch_flagship import build_flagship, build_volume_flagship, icosphere

    store = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="auto", device=cuda).scene.pack.media
    medium = build_volume_flagship(theia_tpu_torch, 64, cuda).params()["medium"]
    c = read_cases(store, medium)[name]
    label, live = {"lanes spread": ("the main path's shape", None), "every lane at one coordinate": (HOT, None),
                   "most lanes dead": (LIVE, READ_LIVE_SHARE)}[traffic]
    if label == HOT:
        c = hot_read_case(c)
    wrapper = table_read.read_packed_grad if c["kernel"] == "read_packed" else table_read.read_table_grad
    before = wrapper.launches
    hold_read_grad(name, c, label, live)
    assert wrapper.launches == before + 1


@pytest.mark.parametrize(
    "label", ["every lane kept", "no lane kept", "every lane in one bin", "a detector axis (3), mask 0.5"]
)
def test_kernel_histogram_backward_on_kept_lane_cases(cuda, label):
    """The kernel histogram's backward (lists of kept lanes dealt a round
    at a time) on ``chip_smoke.kde_cases`` against the plain versions,
    under ``chip_smoke.hold_kde``'s stated tolerances."""
    from chip_smoke import BATCH, kde_cases, hold_kde
    from theia_tpu_torch.response import kernel_histogram_grad

    before = kernel_histogram_grad.launches
    hold_kde(kde_cases(2 * BATCH)[label], label)
    assert kernel_histogram_grad.launches == before + 1
