"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA device and nvcc; without them they skip. On a machine
with a card: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
``chip_smoke.py`` runs the same comparisons at the main path's shapes and
lends its helpers: run ``python -m pytest`` from the repository root, which
puts ``chip_smoke.py`` on the path."""

import dataclasses

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


def test_sobol_kernel_bit_exact(cuda):
    """csrc/sobol.cu against its plain version: table and tail dims, the
    high-bit indices, an offset that wraps, each width; a CUDA tensor
    launches the kernel."""
    from theia_tpu_torch.random import _direction_table, sobol_owen_uniform, sobol_owen_uniform_plain

    n = 5000
    stream = torch.arange(n, dtype=torch.int32, device=cuda) * 858_993 - 2**31
    dim = (torch.arange(n, dtype=torch.int32, device=cuda) * 7) % 80
    for dims, seed in ((1, 0), (64, 0x80000000), (128, 0xFFFFFFFF)):
        table = _direction_table(dims, cuda)
        for width in (1, 2):
            before = sobol_owen_uniform.launches
            got = sobol_owen_uniform(table, seed, stream, dim, width, offset=2**32 - 3)
            torch.cuda.synchronize()
            assert sobol_owen_uniform.launches == before + 1
            want = sobol_owen_uniform_plain(table.cpu(), seed, stream.cpu(), dim.cpu(), width, offset=2**32 - 3)
            assert torch.equal(got.cpu(), want)


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
    "state_of_200_KB": dict(n=20_000, bins=1000, n_det=50),  # past 2^19 tiles x bins: the sparse pass
    "state_of_200_KB_dense_pass": dict(n=4099, bins=1000, n_det=50),  # 5 tiles: the dense pass, 7 ranges
    "large_state": dict(n=20_000, bins=1000, n_det=64),
    "large_state_views_at_element_1": dict(n=20_001, bins=1000, n_det=64, offset=1),
    "large_state_all_kept": dict(n=20_000, bins=1000, n_det=64, kept=1.0),
}


@pytest.mark.parametrize("name", sorted(HIST_CASES))
def test_histogram_kernels_on_cases(cuda, name):
    """The record and its backward against their plain versions on the CPU
    copy, bit for bit, the record launched twice to the same bits, with
    times on exact bin edges, NaN and infinite times among the lanes."""
    import chip_smoke
    from theia_tpu_torch.response import RECORD_RANGE, histogram_add, histogram_grad

    kw = HIST_CASES[name]
    value, time, mask, t0, bin_size, bins, oid, n_det = chip_smoke.hist_case(seed=len(name), **kw)
    # the large states take more ranges than a block's shared memory holds (8)
    assert (bins * (n_det or 1) > 8 * RECORD_RANGE) == name.startswith("large_state")
    assert value.data_ptr() % 16 == 4 * kw.get("offset", 0) and mask.data_ptr() % 4 == kw.get("offset", 0)
    lane = torch.arange(time.shape[0], device=cuda)
    time[lane % 7 == 1] = 5.0 * (lane[lane % 7 == 1] % (bins + 3) - 1).float()  # edges, from below t0 to past the end
    time[lane % 11 == 3] = float("nan")
    time[lane % 13 == 5] = float("inf")
    time[lane % 17 == 7] = float("-inf")
    before = histogram_add.launches, histogram_grad.launches
    chip_smoke.hold_record((value, time, mask, t0, bin_size, bins, oid, n_det), name)
    assert (histogram_add.launches, histogram_grad.launches) == (before[0] + 2, before[1] + 1)


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
    tolerances (the record and the backward bit for bit, each launched
    twice)."""
    from chip_smoke import hold_kde, kde_case
    from theia_tpu_torch.response import kernel_histogram_add, kernel_histogram_grad

    before = kernel_histogram_add.launches, kernel_histogram_grad.launches
    hold_kde(kde_case(**args), label)
    assert (kernel_histogram_add.launches, kernel_histogram_grad.launches) == (before[0] + 2, before[1] + 2)


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
    under ``chip_smoke.check_gather_rows``' checks (bit for bit)."""
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
    """The table reads' backward (the records' fixed order,
    ``ReadGradSource``) on each read case of ``chip_smoke.read_cases``,
    with every lane at one coordinate and with upstream gradients nonzero
    on ``chip_smoke.READ_LIVE_SHARE`` of the lanes, under
    ``chip_smoke.hold_read_grad``: d x and the tables' gradients bit-equal
    to the plain twin, two launches the same bits; one launch a
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
    assert wrapper.launches == before + 2


@pytest.mark.parametrize(
    "label", ["every lane kept", "no lane kept", "every lane in one bin", "a detector axis (3), mask 0.5"]
)
def test_kernel_histogram_backward_on_kept_lane_cases(cuda, label):
    """The kernel histogram's backward (a thread a lane, the scalars in the
    records' fixed order) on ``chip_smoke.kde_cases`` against the plain
    versions, under ``chip_smoke.hold_kde``'s stated checks (bit for bit
    against the twin on the card, two launches the same bits)."""
    from chip_smoke import BATCH, kde_cases, hold_kde
    from theia_tpu_torch.response import kernel_histogram_grad

    before = kernel_histogram_grad.launches
    hold_kde(kde_cases(2 * BATCH)[label], label)
    assert kernel_histogram_grad.launches == before + 2


#: the scenes of ``chip_smoke.walk_cases`` besides each walk's cell scene
#: (None): the tie scenes and one for each table placement
WALK_CASES = {
    "instanced": ("tie, duplicated rows", "tie, coincident instances",
                  "a prototype over the budget: 8 modules of icosphere(5)"),
    "bvh": ("tie, duplicated rows", "tie, coincident instances", "the tests' 27-module array",
            "the sweep's 124 modules"),
}


@pytest.mark.parametrize("name, case", [
    (name, case)
    for name in ("nearest_triangle_instanced", "occluded_instanced", "nearest_triangle_bvh", "occluded_bvh")
    for case in (None, *WALK_CASES["instanced" if name.endswith("instanced") else "bvh"])
])
def test_walk_kernels_bit_equal(cuda, name, case):
    """The four walk entry points against their plain walks, bit for bit,
    on random and adversarial rays (``chip_smoke.walk_adversarial``), the
    plain walk on the card and on the CPU; one launch a call (a group). On
    a cell's scene (``case`` None) and on each of ``chip_smoke.walk_cases``,
    whose tables must get the placement the case names."""
    import theia_tpu_torch
    from chip_smoke import Walk, case_rays, walk_adversarial, walk_cases, walk_rays
    from torch_flagship import build_array, build_flagship, icosphere

    kind = "instanced" if name.endswith("instanced") else "bvh"
    if case is not None:
        build, place = walk_cases(kind, device=cuda)[case]
        scene = build()
    elif kind == "instanced":
        scene = build_array(theia_tpu_torch, icosphere(2), 64, 2, device=cuda).scene
    else:
        scene = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, accel="bvh", device=cuda).scene
    walk = Walk(name, scene.pack)
    if case is not None:
        assert walk.placement().startswith(place), walk.placement()
    random = walk_rays(scene.pack, 10_000, 3) if case is None else case_rays(scene.pack, 10_000, 3)
    for rays in (random, walk_adversarial(scene.pack, 4, per_kind=32)):
        before = walk.kernel.launches
        walk.check(rays, "rays", on_cpu=False)
        assert walk.kernel.launches == before + 1
        walk.check(rays, "rays", on_cpu=True)


#: the record's cases beside ``chip_smoke.kde_cases``: (label, kde_case arguments)
KDE_RECORD_CASES = {
    "1 lane in 1000 kept": dict(n=524_288, seed=24, kept=1e-3),
    "every lane kept with a detector axis": dict(n=524_288, seed=25, n_det=3, kept=1.0),
    "a state of 56,000 flat bins (219 KB of shared memory)": dict(n=100_000, seed=26, bins=1000, n_det=56),
    "a state past shared memory (64,000 flat bins)": dict(n=100_000, seed=9, bins=1000, n_det=64),
    "support 8 on 64,000 flat bins (the dense pass's ranges)": dict(n=100_000, seed=28, bins=1000, n_det=64,
                                                                    support=8),
    "views at element 5, N=4099": dict(n=4099, seed=27, offset=5),
}


@pytest.mark.parametrize(
    "label", ["every lane kept", "no lane kept", "every lane in one bin", "a detector axis (3), mask 0.5",
              *KDE_RECORD_CASES]
)
def test_kernel_histogram_record_on_cases(cuda, label):
    """The kernel histogram's record (the tiles' sums, then the groups', in
    the records' fixed order; past 7,232 flat bins by the sparse pass, or
    in several ranges where its tables do not fit: support 8) on
    ``chip_smoke.kde_cases`` and on sparse, detector-axis, large-state and
    unaligned records, one call a launch of the wrapper, under
    ``chip_smoke.hold_kde``'s stated tolerances (the record bit for bit,
    launched twice)."""
    from chip_smoke import BATCH, hold_kde, kde_case, kde_cases
    from theia_tpu_torch.response import kernel_histogram_add

    case = kde_cases(2 * BATCH)[label] if label not in KDE_RECORD_CASES else kde_case(**KDE_RECORD_CASES[label])
    before = kernel_histogram_add.launches
    hold_kde(case, label)
    assert kernel_histogram_add.launches == before + 2


@pytest.mark.parametrize("label", ["one dim", "dims into the tail", "a table of 300 dims, lanes over all of them",
                                   "offsets that wrap"])
def test_sobol_kernel_byte_table_cases(cuda, label):
    """``csrc/sobol.cu`` (the fold as four lookups in the index's byte
    tables, ``random._byte_table``; the dims past the table on the Philox
    tail) bit for bit against its plain version, width 1 and 2: every lane
    on one dim; dims that cross the table's end; a table of 300 dims with
    the lanes of a warp over all of them and past; offsets that wrap mod
    2^32."""
    from theia_tpu_torch.random import _direction_table, sobol_owen_uniform, sobol_owen_uniform_plain

    n = 20_000
    rng = np.random.default_rng(16)
    stream = torch.as_tensor(rng.integers(-2**31, 2**31, n).astype(np.int32), device=cuda)
    dims, offsets = 128, (0, 12_345)
    if label == "one dim":
        dim = torch.full((n,), 37, dtype=torch.int32, device=cuda)
    elif label == "dims into the tail":
        dims = 64
        dim = torch.as_tensor(rng.integers(58, 70, n).astype(np.int32), device=cuda)
    elif label == "a table of 300 dims, lanes over all of them":
        dims = 300
        dim = torch.as_tensor(rng.integers(0, 320, n).astype(np.int32), device=cuda)
    else:
        dim = torch.as_tensor(rng.integers(0, 74, n).astype(np.int32), device=cuda)
        offsets = (2**32 - 1, 2**32 - 7_000, 2**31)
    table = _direction_table(dims, cuda)
    for offset in offsets:
        for width in (1, 2):
            before = sobol_owen_uniform.launches
            got = sobol_owen_uniform(table, 0xC0FFEE, stream, dim, width, offset)
            torch.cuda.synchronize()
            assert sobol_owen_uniform.launches == before + 1
            want = sobol_owen_uniform_plain(table.cpu(), 0xC0FFEE, stream.cpu(), dim.cpu(), width, offset)
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), (label, offset, width)


@pytest.mark.parametrize("gen", ["philox", "sobol"])
def test_gamma_kernel_bit_exact(cuda, gen):
    """csrc/gamma.cu against its plain version on the card: a lane per
    alpha of chip_smoke.GAMMA_SWEEP, the edge lanes alpha 0 (x = 0) and -1
    (NaN, so R = 64 and the Sobol draws run into the Philox tail), 5000
    lanes (not a multiple of the block); the mixed rounds of
    chip_smoke.gamma_mixed_case (lanes of alphas 0.05-40 with 0, -1 and
    NaN spread over a block's warps and later blocks, 70,000 lanes: more
    tiles than the persistent grid has blocks); one call's kernels counted
    by the profiler; then a scalar alpha, one launch, and a call without
    lanes."""
    import chip_smoke
    from theia_tpu_torch.ops.gamma import sample_gamma

    alpha, rng = chip_smoke.gamma_cases(5000)[gen]
    before = sample_gamma.launches
    info = chip_smoke.hold_gamma(alpha, rng, gen)
    assert sample_gamma.launches == before + 1
    assert info["R"] == 64 and info["nan_lanes"] == 1
    mixed_alpha, mixed = chip_smoke.gamma_mixed_case(70_000)[gen]
    info = chip_smoke.hold_gamma(mixed_alpha, mixed, f"mixed rounds, {gen}")
    assert info["R"] == 64 and info["nan_lanes"] == int(torch.isnan(mixed_alpha).sum() + (mixed_alpha < 0).sum())
    assert sum(chip_smoke.gamma_launches(mixed_alpha, mixed).values()) == chip_smoke.GAMMA_KERNELS_A_CALL
    assert chip_smoke.hold_gamma(torch.tensor(2.7, device=cuda), rng, gen)["R"] < 64
    x, empty = sample_gamma(1.5, dataclasses.replace(rng, stream=rng.stream[:0], dim=rng.dim[:0]))
    assert x.shape == (0,) and empty.dim.shape == (0,)


@pytest.mark.parametrize("segments", [1, 2, 300, "edge lanes", "equal running sums", "zigzag, 300 segments",
                                      "dense zigzag, 300 segments", "a wild row"])
def test_track_kernel_bit_exact(cuda, segments):
    """csrc/cherenkov_track.cu against its plain version on the card, bit
    for bit, with 1, 2 and 300 segments (past one shared-memory tile of
    256) and on chip_smoke.track_rule_cases (the edge lanes: NaN and
    infinite inputs, lanes that are not tame, u at 0, 1 - 2^-24, 1 and NaN,
    totals of 0; equal running sums at u total; the zigzags, the dense one's
    lanes past the kernel's list; a row that is not tame), 10,000 lanes; then
    its gradient on the card against the CPU port's on the same inputs,
    within 1e-5 of each input's largest entry."""
    import chip_smoke
    from theia_tpu_torch.ops.cherenkov_track import track_backward_sample

    if isinstance(segments, int):
        args = chip_smoke.track_case(10_000, segments, segments)
    else:
        args = chip_smoke.track_rule_cases(10_000)[segments]
    before = track_backward_sample.launches
    chip_smoke.hold_track(args, f"{segments} segments")
    assert track_backward_sample.launches == before + 1
    if isinstance(segments, int):
        assert chip_smoke.track_gradient_rel(args) <= 1e-5


def test_wavefront_sort_kernel_bit_equal(cuda):
    """csrc/wavefront_sort.cu against its plain twin (chip_smoke's cases:
    NaN, infinite and huge origins, 1 to 262,144 lanes), and a binned MT
    query, which launches the sort and the scatter back once each,
    bit-equal to the unbinned one."""
    import theia_tpu_torch
    from chip_smoke import check_sort_kernel
    from theia_tpu_torch.ops import _intersect_tiles as tiles
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt
    from torch_flagship import build_flagship, icosphere

    check_sort_kernel()
    pack = build_flagship(theia_tpu_torch, icosphere(2), 64, 2, device=cuda).scene.pack.mt
    rng = np.random.default_rng(4)
    n = 10_001
    o = torch.as_tensor(rng.uniform(-1, 4, (n, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32), device=cuda), dim=1)
    before = tiles.sort_rays.launches, tiles.scatter_back.launches
    t, i = nearest_triangle_mt(pack, o, d, 6.0, binned=True)
    torch.cuda.synchronize()
    assert (tiles.sort_rays.launches, tiles.scatter_back.launches) == (before[0] + 1, before[1] + 1)
    t_u, i_u = nearest_triangle_mt(pack, o, d, 6.0, binned=False)
    assert (i >= 0).any() and torch.equal(i, i_u) and torch.equal(t.view(torch.int32), t_u.view(torch.int32))


def test_params_snapshot_makes_no_host_sync(cuda):
    """``Pipeline.launch`` of example 03's flash behind a queued spin
    kernel: no host sync (torch's sync debug mode, ``chip_smoke.sync_sites``
    names any), and the launch's snapshot equals the CPU tracer's; two
    launches of the same batch give the same light curve bit for bit."""
    import chip_smoke
    import theia_tpu_torch as P
    from theia_tpu_torch.component import map_tensors
    from theia_tpu_torch.pipeline import Pipeline
    from torch_flagship import build_example03

    flash = build_example03(P, 4096, 2, cuda)[0]
    pl = Pipeline(flash)
    pl.launch({}).materialize()  # builds the kernels
    flash.rng.offset = 0
    torch.cuda._sleep(50_000_000)
    launched, sites = chip_smoke.sync_sites(lambda: pl.launch({}))
    assert sites == [], sites
    first = launched.materialize()
    flash.rng.offset = 0
    second = pl.launch({}).materialize()
    assert np.array_equal(first[0].view(np.int32), second[0].view(np.int32)) and first[0].sum() > 0
    card = map_tensors(lambda t: t.cpu(), flash.params())
    host = build_example03(P, 4096, 2, "cpu")[0].params()
    chip_smoke.same_params(card, host)
