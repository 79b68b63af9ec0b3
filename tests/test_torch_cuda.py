"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

CUDA kernels have no CPU mode, so these tests run only where a card is
present; they import no JAX, so on a machine without it they run with

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py imports JAX).  They repeat chip_smoke.py's phases 1-2:
build the kernels, hold each against its plain version at the main path's
shapes, and check a wrapper refuses what its kernel does not take.
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _profiled_kernels(fn, fragment, launched, windows=3):
    """(names, n): the device kernels whose name holds ``fragment`` that
    ``fn`` ran under one torch.profiler window, in launch order, and ``n``,
    the launches the wrappers' counters (``launched()``) rose by in it.

    The profiler on the H100 sometimes drops device events: in probes of
    one or two launches a window, one window in 1,360 lost both its
    kernels, and one run of these tests lost the first kernel of three
    windows, where three more runs with the same windows lost none; the
    cause is not known.  A window whose trace holds fewer kernels than the
    counters say were launched is such a loss, so it is taken again, up
    to ``windows`` windows; a trace with as many kernels or more is
    returned as it is, for the caller to check."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        n0 = launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = launched() - n0
        names = [name for _, name in sorted((e.time_range.start, e.name) for e in prof.events()
                                            if "CUDA" in str(e.device_type) and fragment in e.name)]
        if len(names) >= n:
            break
    return names, n


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    import chip_smoke

    chip_smoke.phase_build()
    recs = chip_smoke.phase_kernels(torch, cuda_device)
    assert set(recs) == {"chain_stats", "chain_stats_kin", "chain_points", "chain_points_kin",
                         "keys", "select", "select_56", "moments", "fit", "pose", "pose_384", "pose_1280",
                         "claim", "probe_planes"}


@pytest.mark.cuda
def test_wrapper_refuses_bad_input_on_card(cuda_device):
    from legkilo_torch.ops import insert_rows as ir

    par = torch.zeros(16, device=cuda_device)
    prow = torch.zeros(12, 128, device=cuda_device)
    brow = torch.zeros(30, 128, device=cuda_device)
    key = torch.zeros(3, 128, device=cuda_device)
    size = torch.ones(1, 128, device=cuda_device)
    n0 = ir.moments_call.launches
    with pytest.raises(ValueError, match="contiguous"):
        ir.moments_call(par, prow, brow.T.contiguous().T, key, size)
    with pytest.raises(ValueError, match="dtype"):
        ir.moments_call(par, prow.double(), brow, key, size)
    assert ir.moments_call.launches == n0
    out = ir.moments_call(par, prow, brow, key, size)
    torch.cuda.synchronize()
    assert ir.moments_call.launches == n0 + 1 and out.shape == (69, 128)


@pytest.mark.cuda
def test_pose_and_fit_wrappers_refuse_bad_input_on_card(cuda_device):
    from legkilo_torch.ops import plane_fit_rows as pfr
    from legkilo_torch.ops import pose_prop as pp

    par = torch.zeros(32, device=cuda_device)
    n0 = pp.pose_call.launches, pfr.fit_rows_call.launches
    with pytest.raises(ValueError, match="up to 6400"):   # 9 x MP floats of shared memory
        pp.pose_call(par, torch.zeros(9, 6528, device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 128"):
        pp.pose_call(par, torch.zeros(9, 100, device=cuda_device))
    with pytest.raises(ValueError, match="32 floats"):
        pp.pose_call(par[:16], torch.zeros(9, 128, device=cuda_device))
    with pytest.raises(ValueError, match="expected"):
        pfr.fit_rows_call(torch.zeros(8, device=cuda_device), torch.zeros(60, 128, device=cuda_device),
                          torch.zeros(4, 128, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        pfr.fit_rows_call(torch.zeros(8, device=cuda_device), torch.zeros(128, 69, device=cuda_device).T,
                          torch.zeros(4, 128, device=cuda_device))
    assert (pp.pose_call.launches, pfr.fit_rows_call.launches) == n0
    out = pp.pose_call(par, torch.zeros(9, 1024, device=cuda_device))
    fit = pfr.fit_rows_call(torch.zeros(8, device=cuda_device), torch.zeros(69, 200, device=cuda_device),
                            torch.zeros(4, 200, device=cuda_device))   # ragged: not a multiple of the block
    torch.cuda.synchronize()
    assert out.shape == (12, 1024) and fit.shape == (35, 200) and bool(torch.isfinite(fit).all())
    assert torch.equal(fit, pfr.fit_rows_plain(torch.zeros(8, device=cuda_device),
                                               torch.zeros(69, 200, device=cuda_device),
                                               torch.zeros(4, 200, device=cuda_device)))
    assert (pp.pose_call.launches, pfr.fit_rows_call.launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
def test_pose_kernel_at_256_slots_on_card(cuda_device):
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import pose_prop as pp

    pargs = cs.pose_inputs(torch, cuda_device, np.random.default_rng(3), 28, 5)
    assert pargs[1].shape[1] == 256
    assert torch.equal(pp.pose_call(*pargs), pp.pose_plain(*pargs))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,k", [(28, 1), (28, 12), (64, 4)], ids=["mp128", "mp384", "nb64_k4"])
def test_pose_kernel_each_shape_on_card(cuda_device, nb, k):
    """The main path's MP 128, MP 384 (12 events a bucket) and the 2 ms
    shape of leg_fusion.yaml (NB 64, K 4: MP 384): one launch a call, two
    launches bit-equal to each other and to ``pose_plain``."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import pose_prop as pp

    pargs = cs.pose_inputs(torch, cuda_device, np.random.default_rng(nb + k), nb, k)
    n0 = pp.pose_call.launches
    got = pp.pose_call(*pargs)
    again = pp.pose_call(*pargs)
    torch.cuda.synchronize()
    assert pp.pose_call.launches == n0 + 2
    assert torch.equal(got, again) and torch.equal(got, pp.pose_plain(*pargs))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3, 4])
@pytest.mark.parametrize("c", [128, 300, 3584, 4096])
def test_keys_kernel_on_card(cuda_device, c, levels):
    """The 32-row tile kernel at the main path's C = 3584, a ragged C = 300
    (12 live lanes in the last tile), C = 128 (four tiles) and C = 4096
    (past the path's cap), at 1 to 4 levels: keys, centres and probe
    starts ``torch.equal`` to ``keys_plain``, p_i/p_w rel 1e-6 and
    covariances rel 1e-5 (chip_smoke's tolerances), two launches bit-equal."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import match_geom as mg

    kargs = cs.keys_inputs(torch, cuda_device, np.random.default_rng(c + levels), c=c, levels=levels)
    n0 = mg.keys_call.launches
    got = mg.keys_call(*kargs, levels, 1 << 14)
    again = mg.keys_call(*kargs, levels, 1 << 14)
    torch.cuda.synchronize()
    assert mg.keys_call.launches == n0 + 2
    ref = mg.keys_plain(*kargs, levels, 1 << 14)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in ref]
    for i in (2, 3, 4):
        assert torch.equal(got[i], ref[i]), i
    assert cs.rel_err(got[0], ref[0]) <= 1e-6 and cs.rel_err(got[1], ref[1]) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_keys_wrapper_refuses_bad_input_on_card(cuda_device):
    """keys_call refuses a wrong row count, a short par, a level count past
    4, a float64 or a non-contiguous input, each before any launch."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import match_geom as mg

    par, pts, rb, pb = cs.keys_inputs(torch, cuda_device, np.random.default_rng(2), c=300, levels=3)
    n0 = mg.keys_call.launches
    with pytest.raises(ValueError, match="expected"):
        mg.keys_call(par, pts, rb[:, :299].contiguous(), pb, 3, 1 << 14)
    with pytest.raises(ValueError, match="64 floats"):
        mg.keys_call(par[:32], pts, rb, pb, 3, 1 << 14)
    with pytest.raises(ValueError, match="levels"):
        mg.keys_call(par, pts, rb, pb, 5, 1 << 14)
    with pytest.raises(ValueError, match="dtype"):
        mg.keys_call(par, pts.double(), rb, pb, 3, 1 << 14)
    with pytest.raises(ValueError, match="contiguous"):
        mg.keys_call(par, pts, rb, pb.T.contiguous().T, 3, 1 << 14)
    assert mg.keys_call.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("nb,k", [(256, 4), (1000, 5)], ids=["mp1280", "mp6016"])
def test_pose_kernel_past_1024_slots_on_card(cuda_device, nb, k):
    """Past 1,024 timeline slots each thread takes several (two at
    MP = 1,280, eight at 6,016): bit-equal to the plain version, as one slot
    a thread is."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import pose_prop as pp

    pargs = cs.pose_inputs(torch, cuda_device, np.random.default_rng(3), nb, k)
    assert pargs[1].shape[1] == (nb * (k + 1) + 127) // 128 * 128 > 1024
    n0 = pp.pose_call.launches
    got = pp.pose_call(*pargs)
    torch.cuda.synchronize()
    assert pp.pose_call.launches == n0 + 1
    assert torch.equal(got, pp.pose_plain(*pargs))


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_kernels_other_shapes_on_card(cuda_device, use_kin):
    """Shapes off the main path: K = 2 event slots a bucket for the chain,
    and a ragged row count (not a multiple of the block) for the others."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_stats, insert_rows, match_geom

    rng = np.random.default_rng(5)
    args = cs.chain_inputs(torch, cuda_device, rng, use_kin, nb=8, k=2)
    got = chain_stats.chain_call(*args, use_kin=use_kin)
    ref = chain_stats.chain_plain(*args, use_kin=use_kin)
    for i, (a, b) in enumerate(zip(got, ref)):  # chip_smoke's tolerances
        assert cs.rel_err(a, b) <= (1e-3 if i in (2, 3, 7) else 1e-4), i

    kargs = cs.keys_inputs(torch, cuda_device, rng, c=300, levels=2)
    kg = match_geom.keys_call(*kargs, 2, 1 << 10)
    kr = match_geom.keys_plain(*kargs, 2, 1 << 10)
    for i in (2, 3, 4):
        assert torch.equal(kg[i], kr[i])
    assert cs.rel_err(kg[0], kr[0]) <= 1e-6 and cs.rel_err(kg[1], kr[1]) <= 1e-5

    sargs = cs.select_inputs(torch, cuda_device, rng, kg, nb=5, levels=2)
    cs.select_check(torch, sargs, 2, 5)

    margs = cs.moments_inputs(torch, cuda_device, rng, r=300)
    got = torch.cat(insert_rows.moments_rows_call(*margs), dim=1)
    assert cs.rel_err(got, torch.cat(insert_rows.moments_rows_plain(*margs), dim=1)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_points_other_shapes_on_card(cuda_device, use_kin):
    """The per-point chain off the path's shape: K = 2 event slots, P = 200
    points a bucket (not a multiple of the block), with its empty and its
    gated-off bucket; chip_smoke's tolerances; and the wrapper refuses a
    wrong shape without launching."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_points as cp

    args = cs.chain_points_inputs(torch, cuda_device, np.random.default_rng(5), use_kin, nb=9, k=2, p=200)
    got = cp.chain_points_call(*args, use_kin=use_kin)
    ref = cp.chain_points_plain(*args, use_kin=use_kin)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert cs.rel_err(a, b) <= (1e-3 if i in (2, 3, 7) else 1e-4), i
    assert int(got[4][3]) == 0 and int(got[4][6]) == 0 and int(got[4].sum()) > 500
    n0 = cp.chain_points_call.launches
    with pytest.raises(ValueError, match="expected"):
        cp.chain_points_call(*args[:18], args[18][:, :100].contiguous(), use_kin=use_kin)
    with pytest.raises(ValueError, match="contiguous"):
        cp.chain_points_call(*args[:14], args[14].transpose(1, 2).contiguous().transpose(1, 2),
                             *args[15:], use_kin=use_kin)
    assert cp.chain_points_call.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
@pytest.mark.parametrize("nb,k,p", [(28, 1, 256), (56, 1, 128), (8, 2, 200), (9, 1, 97), (4, 1, 2048)],
                         ids=["nb28_k1_p256", "nb56_k1_p128", "nb8_k2_p200", "nb9_k1_p97", "nb4_p_max"])
def test_chain_points_warp_kernel_on_card(cuda_device, nb, k, p, use_kin):
    """The one-warp per-point chain of either branch against its plain
    version at the path's shapes (NB 28 / P 256; 2 ms buckets, NB 56 / P
    128), with K = 2, at P = 200 (a multiple of 4: 16-byte copies) and
    P = 97 (4-byte copies), and at P = MAX_P: chip_smoke's tolerances,
    counts and clocks exact, the empty and the gated-off bucket without a
    match, two launches bit-equal."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_points as cp

    assert p <= cp.MAX_P
    args = cs.chain_points_inputs(torch, cuda_device, np.random.default_rng(nb + k + p), use_kin, nb, k, p)
    n0 = cp.chain_points_call.launches
    got = cp.chain_points_call(*args, use_kin=use_kin)
    again = cp.chain_points_call(*args, use_kin=use_kin)
    torch.cuda.synchronize()
    ref = cp.chain_points_plain(*args, use_kin=use_kin)
    assert cp.chain_points_call.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, (a, b) in enumerate(zip(got, ref)):
        if i in (4, 8):
            assert torch.equal(a, b), i
        else:
            assert cs.rel_err(a, b) <= (1e-3 if i in (2, 3, 7) else 1e-4), i
    assert int(got[4][2 * nb // 3]) == 0 and int(got[4][nb // 3]) == 0 and int(got[4].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_points_unaligned_rows_give_the_same_bits_on_card(cuda_device, use_kin):
    """Point rows at an offset of one float (P = 256 but not 16-byte
    aligned) take the 4-byte copies; the kernel's arithmetic is the same,
    so the outputs equal those from aligned rows bit for bit."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_points as cp

    args = cs.chain_points_inputs(torch, cuda_device, np.random.default_rng(6), use_kin, 8, 1, 256)
    shifted = list(args)
    for i in (14, 15, 16, 17, 18):
        buf = torch.zeros(args[i].numel() + 1, device=cuda_device)
        shifted[i] = buf[1:].view(args[i].shape)
        shifted[i].copy_(args[i])
        assert shifted[i].data_ptr() % 16 and shifted[i].is_contiguous()
    got = cp.chain_points_call(*args, use_kin=use_kin)
    off = cp.chain_points_call(*shifted, use_kin=use_kin)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, off))


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_points_refuses_staging_past_shared_memory_on_card(cuda_device, use_kin):
    """P past MAX_P, or event rows that with the ring pass STAGED_MAX
    bytes, are refused before any launch."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_points as cp

    n0 = cp.chain_points_call.launches
    args = cs.chain_points_inputs(torch, cuda_device, np.random.default_rng(8), use_kin, 2, 1, cp.MAX_P + 4)
    with pytest.raises(ValueError, match="shared memory"):
        cp.chain_points_call(*args, use_kin=use_kin)
    nb, k = 200, 8 if use_kin else 32
    assert cp.staged_bytes(nb, k, 64, use_kin) > cp.STAGED_MAX
    args = cs.chain_points_inputs(torch, cuda_device, np.random.default_rng(8), use_kin, nb, k, 64)
    with pytest.raises(ValueError, match="shared memory"):
        cp.chain_points_call(*args, use_kin=use_kin)
    assert cp.chain_points_call.launches == n0


@pytest.mark.cuda
def test_chain_points_routes_by_use_kin_on_card(cuda_device):
    """Both branches of the per-point chain launch the one-warp kernel, each
    its own instantiation, and no block kernel is left: in one
    torch.profiler window over a launch of each branch, the per-point chain
    kernels on the card, in launch order, are exactly
    chain_points_warp_kernel<false> and chain_points_warp_kernel<true>."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_points as cp

    calls = [(use_kin, cs.chain_points_inputs(torch, cuda_device, np.random.default_rng(4), use_kin, 8, 1, 64))
             for use_kin in (False, True)]
    for use_kin, args in calls:
        cp.chain_points_call(*args, use_kin=use_kin)
    torch.cuda.synchronize()
    names, n = _profiled_kernels(lambda: [cp.chain_points_call(*a, use_kin=u) for u, a in calls],
                                 "chain_points", lambda: cp.chain_points_call.launches)
    assert n == 2 and len(names) == 2, names
    assert "chain_points_warp_kernel<false>" in names[0] and "chain_points_warp_kernel<true>" in names[1], names


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
@pytest.mark.parametrize("nb,k", [(28, 1), (56, 1), (64, 4), (8, 2), (1, 1)],
                         ids=["nb28_k1", "nb56_k1", "nb64_k4", "nb8_k2", "nb1"])
def test_chain_warp_kernel_on_card(cuda_device, nb, k, use_kin):
    """The one-warp kernel of either branch against its plain version, with
    a gated-off and an empty bucket and, kin, an event without contact (at
    NB = 1 one bucket is all three): chip_smoke's tolerances, counts and
    clocks exact, two launches bit-equal."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_stats

    args = cs.chain_holes(cs.chain_inputs(torch, cuda_device, np.random.default_rng(nb + k), use_kin, nb, k))
    n0 = chain_stats.chain_call.launches
    got = chain_stats.chain_call(*args, use_kin=use_kin)
    again = chain_stats.chain_call(*args, use_kin=use_kin)
    torch.cuda.synchronize()
    ref = chain_stats.chain_plain(*args, use_kin=use_kin)
    assert chain_stats.chain_call.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, (a, b) in enumerate(zip(got, ref)):
        if i in (4, 8):
            assert torch.equal(a, b), i
        else:
            assert cs.rel_err(a, b) <= (1e-3 if i in (2, 3, 7) else 1e-4), i
    assert int(got[4][2 * nb // 3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_call_refuses_unaligned_s40_on_card(cuda_device, use_kin):
    """The warp kernel copies s40 16 bytes at a time: a view at an offset of
    one float is refused before any launch."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_stats

    args = cs.chain_inputs(torch, cuda_device, np.random.default_rng(2), use_kin, 8, 1)
    buf = torch.zeros(8 * 1600 + 1, device=cuda_device)
    s40 = buf[1:].view(8, 40, 40)
    s40.copy_(args[13])
    n0 = chain_stats.chain_call.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        chain_stats.chain_call(*args[:13], s40, use_kin=use_kin)
    assert chain_stats.chain_call.launches == n0


@pytest.mark.cuda
def test_chain_call_routes_by_use_kin_on_card(cuda_device):
    """Both branches launch the one-warp kernel, each its own instantiation
    (use_kin = False chain_warp_kernel<false>, True chain_warp_kernel<true>),
    and no block chain_kernel is left: in one torch.profiler window over a
    launch of each branch, the chain kernels on the card, in launch order,
    are exactly those two."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import chain_stats

    calls = [(use_kin, cs.chain_inputs(torch, cuda_device, np.random.default_rng(4), use_kin, 8, 1))
             for use_kin in (False, True)]
    for use_kin, args in calls:
        chain_stats.chain_call(*args, use_kin=use_kin)
    torch.cuda.synchronize()
    names, n = _profiled_kernels(lambda: [chain_stats.chain_call(*a, use_kin=u) for u, a in calls],
                                 "chain", lambda: chain_stats.chain_call.launches)
    assert n == 2 and len(names) == 2, names
    assert "chain_warp_kernel<false>" in names[0] and "chain_warp_kernel<true>" in names[1], names


def _select_case(case, dev):
    """chip_smoke's select inputs for one case: (args, levels, n_buckets)."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import match_geom

    rng = np.random.default_rng(11)
    nb = {"nb56_p128": 56, "nb64_p128": 64}.get(case, 28)
    c, levels, nb = (300, 2, 5) if case == "c300_nb5_l2" else (3584, 3, nb)
    kargs = cs.keys_inputs(torch, dev, rng, c=c, levels=levels)
    sargs = cs.select_inputs(torch, dev, rng, match_geom.keys_call(*kargs, levels, 1 << 14), nb=nb, levels=levels)
    if case == "shuffled":
        sargs = cs.shuffled_bidx(torch, sargs, rng)
    elif case == "empty_bucket":
        sargs[7][sargs[7] == 3.0] = 4.0
    elif case == "bucket_over_256":
        sargs[7][0, 100:700] = 2.0   # 600 rows, three groups of at most 256
    return sargs, levels, nb


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c3584_nb28_l3", "nb56_p128", "nb64_p128", "c300_nb5_l2", "shuffled",
                                  "empty_bucket", "bucket_over_256"])
def test_select_kernel_on_card(cuda_device, case):
    """The one-launch select kernel against select_plain with chip_smoke's
    tolerances (matched on >= 99.9 % of rows, rows rel 1e-4, s40 rel 1e-5
    against float64 sums of its own rows and rel 1e-4 against the plain
    version with the flipped rows' terms out, counts exact), two launches
    bit-equal, at the main path's shape, the 2 ms bucket shapes (NB 56, and
    leg_fusion.yaml's 64), a small one,
    with the bucket indices shuffled, with an empty bucket and with a bucket
    of more rows than one group holds."""
    import chip_smoke as cs
    from legkilo_torch.ops import match_geom

    sargs, levels, nb = _select_case(case, cuda_device)
    n0 = match_geom.select_call.launches
    (out, s40, nm), _, _ = cs.select_check(torch, sargs, levels, nb)
    assert match_geom.select_call.launches == n0 + 2
    b = sargs[7][0]
    if case == "empty_bucket":
        assert not bool((b == 3.0).any()) and int(nm[3, 0]) == 0 and not bool(s40[120:160].any())
    if case == "bucket_over_256":
        assert int((b == 2.0).sum()) > 256 and int(nm[2, 0]) > 0


@pytest.mark.cuda
def test_select_one_kernel_a_call_on_card(cuda_device):
    """select_call is one launch: under torch.profiler, two calls run
    exactly two kernels on the card, both the select kernel."""
    from legkilo_torch.ops import match_geom

    sargs, levels, nb = _select_case("c3584_nb28_l3", cuda_device)
    match_geom.select_call(*sargs, levels, nb)
    torch.cuda.synchronize()
    names, n = _profiled_kernels(lambda: [match_geom.select_call(*sargs, levels, nb) for _ in range(2)],
                                 "", lambda: match_geom.select_call.launches)
    assert n == 2 and len(names) == 2 and all("select_kernel" in name for name in names), names


def _rel_err_by_column(got, ref):
    return max(float((got[:, i].double() - ref[:, i].double()).abs().max()
                     / max(float(ref[:, i].double().abs().max()), 1e-30)) for i in range(got.shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,r", [(28, 4096), (56, 4096), (28, 4000), (56, 300)])
def test_moments_rows_kernel_on_card(cuda_device, nb, r):
    """The indexed moments kernel at the path's NB = 28 and the 2 ms
    buckets' 56, R a multiple of the 32-row tile and not: rel 1e-4 a moment
    row against ``moments_rows_plain`` (chip_smoke's tolerance), two
    launches bit-equal."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import insert_rows as ir

    margs = cs.moments_inputs(torch, cuda_device, np.random.default_rng(nb + r), r=r, nb=nb)
    n0 = ir.moments_rows_call.launches
    got = ir.moments_rows_call(*margs)
    again = ir.moments_rows_call(*margs)
    torch.cuda.synchronize()
    assert ir.moments_rows_call.launches == n0 + 2
    assert got[0].shape == (r, 9) and got[1].shape == (r, 60)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ir.moments_rows_plain(*margs)
    assert _rel_err_by_column(torch.cat(got, dim=1), torch.cat(ref, dim=1)) <= 1e-4


def _card_map_tables(dev, storage, budget, seed=0):
    """The sentinel-extended tables of a map built on the card from a scene
    of planes and scatter (plain refit), moms in ``storage``, and refit rows
    naming occupied slots for three quarters of ``budget``, then the
    sentinel row."""
    import numpy as np

    from legkilo_torch.core import voxel_map as tv

    rng = np.random.default_rng(seed)
    cfg = tv.MapConfig(levels=3, capacity=1024, probe=4, voxel_size=0.5, planer_threshold=0.01,
                       sigma_num=3.0, max_points_num=50, init_num=(5, 5, 5), insert_rounds=2,
                       refit_budget=256, storage_dtype=storage)
    pts = []
    for axis, off in ((2, 0.1), (0, 1.3), (1, -1.2)):
        uv = rng.uniform(-2, 2, size=(600, 3))
        uv[:, axis] = off + rng.normal(scale=0.003, size=600)
        pts.append(uv)
    pts.append(rng.uniform(-3, 3, size=(400, 3)))
    p = np.concatenate(pts)
    a = rng.normal(size=(len(p), 3, 3)) * 0.01
    var = a @ np.swapaxes(a, 1, 2) + 1e-6 * np.eye(3)
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    vm = tv.insert_points(tv.make_map(cfg, dev), cfg, f(p), f(var), torch.ones(len(p), dtype=torch.bool, device=dev))
    miss = vm.meta.shape[0]
    occ = torch.nonzero(vm.meta[:, 0] > 0)[:, 0][: budget * 3 // 4]
    fs = torch.full((budget,), miss, dtype=torch.int64, device=dev)
    fs[: len(occ)] = occ
    tables = [tv._with_sentinel(t) for t in (vm.meta, vm.mom, vm.moms)]
    assert tables[2].dtype == tv._STORAGE[storage] and len(occ) > budget // 2
    return tables, fs


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [1024, 250])
@pytest.mark.parametrize("storage", ["f32", "f16", "bf16"])
def test_fit_slots_kernel_on_card(cuda_device, storage, budget):
    """The indexed refit kernel on a card-built map's tables in each storage
    dtype, refit rows with sentinel padding, a budget that fills the last
    block and one that does not: ``torch.equal`` to ``fit_slots_plain``,
    two launches bit-equal."""
    from legkilo_torch.ops import plane_fit_rows as pfr

    tables, fs = _card_map_tables(cuda_device, storage, budget)
    par = pfr.fit_par(0.01, cuda_device)
    n0 = pfr.fit_slots_call.launches
    got = pfr.fit_slots_call(par, *tables, fs)
    again = pfr.fit_slots_call(par, *tables, fs)
    torch.cuda.synchronize()
    assert pfr.fit_slots_call.launches == n0 + 2
    assert got.shape == (budget, 35) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    ref = pfr.fit_slots_plain(par, *tables, fs)
    assert torch.equal(got, ref), int((got != ref).any(dim=1).sum())
    assert float(got[:, 34].sum()) > 10


@pytest.mark.cuda
def test_moments_and_fit_slots_refuse_bad_input_on_card(cuda_device):
    """Wrong shapes, dtypes, devices and strides, and an empty bucket table,
    are refused before any launch.  The kernels read elements, not vectors: a table
    starting one element past an aligned address gives the same bits."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.ops import plane_fit_rows as pfr

    m = list(cs.moments_inputs(torch, cuda_device, np.random.default_rng(4), r=300))
    tables, fs = _card_map_tables(cuda_device, "f32", 256)
    par = pfr.fit_par(0.01, cuda_device)

    def with_(i, x, args):
        return args[:i] + [x] + args[i + 1:]

    n0 = ir.moments_rows_call.launches, pfr.fit_slots_call.launches
    bad_moments = [
        (with_(2, m[2].transpose(1, 2), m), "contiguous"),          # rots
        (with_(3, m[3].double(), m), "dtype"),                      # poss
        (with_(10, m[10].long(), m), "dtype"),                      # keys
        (with_(9, m[9].cpu(), m), "cpu"),                           # bidx
        (with_(9, m[9][:-1], m), "bidx"),
        (with_(7, m[7].transpose(1, 2), m), "one stride"),          # body_cov_c
        (with_(2, m[2][:0], with_(3, m[3][:0], with_(4, m[4][:0], with_(5, m[5][:0], m)))), "buckets"),
    ]
    for args, msg in bad_moments:
        with pytest.raises(ValueError, match=msg):
            ir.moments_rows_call(*args)
    meta_x, mom_x, moms_x = tables
    bad_fit = [
        ((par, meta_x[:, 0:3].contiguous(), mom_x, moms_x, fs), "shape"),
        ((par, meta_x, mom_x, moms_x.to(torch.int32), fs), "dtype"),
        ((par, meta_x, mom_x, moms_x, fs.to(torch.int32)), "dtype"),
        ((par, meta_x, mom_x, moms_x, fs.cpu()), "cpu"),
        ((par, meta_x, mom_x.T.contiguous().T, moms_x, fs), "contiguous"),
        ((par[0:4], meta_x, mom_x, moms_x, fs), "8 floats"),
    ]
    for args, msg in bad_fit:
        with pytest.raises(ValueError, match=msg):
            pfr.fit_slots_call(*args)
    assert (ir.moments_rows_call.launches, pfr.fit_slots_call.launches) == n0

    def off_by_one(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    got = pfr.fit_slots_call(par, *[off_by_one(t) for t in tables], fs)
    assert torch.equal(got, pfr.fit_slots_call(par, *tables, fs))
    mo = ir.moments_rows_call(*[off_by_one(t) if i in (2, 3, 4, 5) else t for i, t in enumerate(m)])
    assert all(torch.equal(a, b) for a, b in zip(mo, ir.moments_rows_call(*m)))


@pytest.mark.cuda
def test_moments_and_fit_one_kernel_a_call_on_card(cuda_device):
    """Each indexed entry is one device kernel and nothing else: no gather,
    copy or fill in front of it."""
    import numpy as np

    import chip_smoke as cs
    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.ops import plane_fit_rows as pfr

    margs = cs.moments_inputs(torch, cuda_device, np.random.default_rng(6))
    tables, fs = _card_map_tables(cuda_device, "f16", 1024)
    par = pfr.fit_par(0.01, cuda_device)
    ir.moments_rows_call(*margs)
    pfr.fit_slots_call(par, *tables, fs)
    torch.cuda.synchronize()
    names, n = _profiled_kernels(lambda: ir.moments_rows_call(*margs), "",
                                 lambda: ir.moments_rows_call.launches)
    assert n == 1 and len(names) == 1 and "moments_kernel" in names[0], names
    names, n = _profiled_kernels(lambda: pfr.fit_slots_call(par, *tables, fs), "",
                                 lambda: pfr.fit_slots_call.launches)
    assert n == 1 and len(names) == 1 and "fit_slots_kernel" in names[0], names


_TRAP_SCRIPT = """
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from legkilo_torch.ops import insert_rows as ir
from legkilo_torch.ops import plane_fit_rows as pfr

dev, case = torch.device("cuda"), sys.argv[1]
m = list(cs.moments_inputs(torch, dev, np.random.default_rng(4), r=300))
mm, b = 50, 256
tables = [torch.zeros((mm, w), device=dev) for w in (4, 9, 60)]
fs = torch.arange(b, device=dev) % mm
if case == "fs":
    fs[7] = mm
elif case == "pidx":
    m[8][5] = m[6].shape[0]
elif case == "lvl":
    m[11][9] = m[1].shape[0]
elif case == "bidx":
    m[9][m[8][3]] = -1
try:
    ir.moments_rows_call(*m)
    pfr.fit_slots_call(pfr.fit_par(0.01, dev), *tables, fs)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("trapped:", e)
    sys.exit(3)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["none", "fs", "pidx", "lvl", "bidx"])
def test_index_outside_its_table_traps_on_card(cuda_device, case):
    """An index that names no row of its table (fs past the map's tables,
    pidx past the points, lvl past the sizes, a negative bidx) fails the
    launch's stream, as indexing a CUDA tensor asserts, instead of reading
    past the table.  The trap spoils the process's CUDA context, so each
    case runs in a process of its own."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _TRAP_SCRIPT, case], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == (0 if case == "none" else 3), run.stdout + run.stderr


def _sim_runner(cfg, duration):
    """Stream ``duration`` s of the bench sim (seed 7, 8,000 points a scan)
    through a runner on the card; returns the runner."""
    from legkilo_torch.models import sim
    from legkilo_torch.runner import OdometryRunner, replay

    data = sim.simulate(sim.SimConfig(duration=duration, scan_points=8000, seed=7))
    runner = OdometryRunner(cfg, device="cuda")
    for _ in replay(runner, data.scans, data.imu):
        pass
    return runner


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_ordered_sum_is_the_cpu_order_on_card(cuda_device, dtype):
    """index_add_rows on the card against index_add_ of the same tensors on
    the CPU: bit-equal in f32 (the map's mom and meta tables, s40) and in
    the narrow moms tables (f16, bf16), on every row but the dropped one.
    Two calls on the card are bit-equal."""
    import numpy as np

    from legkilo_torch.core import ordered_sum

    dt = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(5)
    for width, m, r in (((4,), 3000, 12288), ((9,), 3000, 12288), ((60,), 3000, 12288), ((40, 40), 29, 3584)):
        dest = torch.from_numpy(rng.normal(scale=3.0, size=(m,) + width).astype(np.float32)).to(dt)
        src = torch.from_numpy(rng.normal(size=(r,) + width).astype(np.float32))
        tgt = torch.from_numpy(rng.integers(0, m // 3, size=r)).to(torch.int64)
        tgt[::9] = m - 1
        ref = dest.clone().index_add_(0, tgt, src.to(dt))
        outs = []
        for _ in range(2):
            got = dest.to(cuda_device)
            ordered_sum.index_add_rows([got], tgt.to(cuda_device), [src.to(cuda_device)], drop=m - 1)
            outs.append(got[: m - 1].cpu())
        assert torch.equal(outs[0], outs[1]), width
        assert torch.equal(outs[0], ref[: m - 1]), width


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_ordered_sum_by_replica_is_the_cpu_order_on_card(cuda_device, dtype):
    """index_add_rows of a fleet's insert rows (64 replicas of 4,096 rows,
    each aiming at its own 3,000 table rows and at the dropped row), summed
    a replica at a time (``groups`` 64) on the card: index_add_'s bits on
    the CPU, in the map's widths (meta 4, mom 9, moms 60); two calls
    bit-equal."""
    import numpy as np

    from legkilo_torch.core import ordered_sum

    dt = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(6)
    b, m, rows = 64, 4096, 3000
    drop = b * rows
    tgt = torch.from_numpy(rng.integers(0, rows // 3, size=(b, m)) + rows * np.arange(b)[:, None])
    tgt = tgt.reshape(-1).to(torch.int64)
    tgt[::9] = drop
    for width in ((4,), (9,), (60,)):
        dest = torch.from_numpy(rng.normal(scale=3.0, size=(drop + 1,) + width).astype(np.float32)).to(dt)
        src = torch.from_numpy(rng.normal(size=(b * m,) + width).astype(np.float32))
        ref = dest.clone().index_add_(0, tgt, src.to(dt))
        outs = []
        for _ in range(2):
            got = dest.to(cuda_device)
            ordered_sum.index_add_rows([got], tgt.to(cuda_device), [src.to(cuda_device)], drop=drop,
                                       groups=b)
            outs.append(got[:drop].cpu())
        assert torch.equal(outs[0], outs[1]), width
        assert torch.equal(outs[0], ref[:drop]), width


@pytest.mark.cuda
def test_two_runs_of_the_five_kernel_path_are_equal_on_card(cuda_device):
    """The fused path with all five kernels, twice over the same 3 s of the
    bench sim: bit-equal trajectories and final map tables."""
    from legkilo_torch.runner import bench_config

    runs = [_sim_runner(bench_config(), 3.0) for _ in range(2)]
    a, b = runs
    assert len(a.results) == len(b.results) >= 25
    for ra, rb in zip(a.results, b.results):
        assert (ra.pos == rb.pos).all() and (ra.rot == rb.rot).all()
    for f in ("ptab", "meta", "mom", "moms", "plane", "ocnt"):
        assert torch.equal(getattr(a.carry.vm, f), getattr(b.carry.vm, f)), f


@pytest.mark.cuda
def test_moments_kernel_takes_the_xla_match_rows_on_card(cuda_device):
    """The moments kernel fed by the match on its torch path
    (``_match_compact_stats``: contiguous [cap, 3] and [cap, 3, 3] rows,
    int32 keys) against its plain version on the same inputs (chip_smoke's
    tolerance, rel 1e-5), from a map a short run of the mixed configuration
    left."""
    from legkilo_torch.core import filter_deferred as fd
    from legkilo_torch.core.voxel_map import gated_insert_rows
    from legkilo_torch.io.dataset import PacketBuilder, to_device_packet
    from legkilo_torch.models import sim
    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.runner import OdometryRunner, bench_config
    import chip_smoke

    cfg = bench_config()
    cfg.tpu.use_pallas_match = False
    data = sim.simulate(sim.SimConfig(duration=1.5, scan_points=8000, seed=7))
    b = PacketBuilder(cfg)
    for ev in data.imu:
        b.add_imu(ev)
    raws, pkts = [], []
    for scan in data.scans:
        b.add_scan(scan)
        while b.ready():
            raws.append(b._scans[0])
            pkts.append(b.pop())
    runner = OdometryRunner(cfg, device="cuda")
    runner._initialize(raws[0], pkts[0])
    for pk in pkts[1:-1]:
        runner._dispatch(pk)
    runner.flush()
    dev_pkt = to_device_packet(pkts[-1], cuda_device)
    scfg, params, carry = runner.scfg, runner.params, runner.carry
    nb, p = dev_pkt.points.shape[0:2]
    cap = fd._row_cap(scfg, nb, p)
    s40, nm, aux = fd._match_compact_stats(carry, dev_pkt, params, scfg, cap)
    order, bidx, p_i_c, body_cov_c, mask_c, *own = aux
    assert p_i_c.is_contiguous() and body_cov_c.is_contiguous() and own[0].dtype == torch.int32
    _, rots, poss, rot_covs, pos_covs, _ = fd.run_chain_stats(carry, dev_pkt, params, s40, nm)
    rows = gated_insert_rows(scfg.map_cfg, mask_c, *own)
    sizes = ir.level_sizes(scfg.map_cfg.voxel_size, scfg.map_cfg.levels, p_i_c.device)
    args = (params.ext_r, sizes, rots, poss, rot_covs, pos_covs, p_i_c, body_cov_c, rows.pidx, bidx,
            rows.keys, rows.lvl)
    n0 = ir.moments_rows_call.launches
    got = ir.moments_rows_call(*args)
    assert ir.moments_rows_call.launches == n0 + 1
    ref = ir.moments_rows_plain(*args)
    for a, r in zip(got, ref):
        assert chip_smoke.rel_err(a, r) <= 1e-5


@pytest.mark.cuda
def test_ragged_caps_launch_the_kernels_on_card(cuda_device):
    """A match cap of 1,100, an insert row cap of 1,000 and a refit budget
    of 1,000 (no multiple of 128, which would send the JAX package to its
    XLA path) still run the keys, select, moments and fit kernels on the
    card: the route follows the switches alone."""
    import numpy as np

    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.ops import match_geom as mg
    from legkilo_torch.ops import plane_fit_rows as pfr
    from legkilo_torch.runner import bench_config

    cfg = bench_config()
    cfg.tpu.match_cap = cfg.tpu.insert_cap = 1100
    cfg.voxel_map.insert_row_cap = 1000
    cfg.voxel_map.refit_budget = 1000
    calls = (mg.keys_call, mg.select_call, ir.moments_rows_call, pfr.fit_slots_call)
    before = [c.launches for c in calls]
    runner = _sim_runner(cfg, 1.5)
    assert len(runner.results) >= 10
    assert all(c.launches > n for c, n in zip(calls, before)), [c.launches - n for c, n in zip(calls, before)]
    assert all(np.isfinite(r.pos).all() for r in runner.results)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin,bound", [(False, 0.08), (True, 0.12)], ids=["imu", "kin"])
def test_run_replays_a_bag_on_card(cuda_device, tmp_path, capsys, use_kin, bound):
    """``python -m legkilo_torch run`` on the card (its default device) on
    tests/test_torch_bag.py's ~2 s bags: the ATE bounds of
    tests/test_bag_e2e.py, and every kernel of the five-kernel path
    launched (the chain's kin branch from the HighState bag)."""
    import json

    import chip_smoke as cs
    from legkilo_torch import cli
    from torch_util import bag_ate, write_bag_run

    bag, cfg, _, data = write_bag_run(tmp_path, use_kin)
    traj = str(tmp_path / "traj.txt")
    cs.reset_counters()
    assert cli.main(["run", "--config_file", cfg, "--bag", bag, "--traj_out", traj,
                     "--export_planes", str(tmp_path / "planes.ply")]) == 0
    counts = cs.read_counters()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ate, pairs = bag_ate(traj, data)
    assert pairs >= 18 and ate < bound, (ate, pairs)
    assert rec["scans"] >= len(data.scans)
    assert all(counts[k] >= len(data.scans) for k in cs.FUSED_KERNELS), counts
    assert counts["chain_points"] == 0


# ------------------------------------------------------------ the claims --


@pytest.fixture(scope="module", params=["fused", "points"])
def claim_fleet_calls(request):
    """The claim calls of a fleet of 4 replicas of the bench sim on the card
    (3 levels of 2^12 slots, probe 8, 6 rounds), each copied before it ran:
    a replica's first frame (insert_points), then two fleet steps' inserts
    (fused: the gated rows; per-point: every (point, level) row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    import chip_smoke

    chip_smoke.phase_build()
    cfg = chip_smoke.claim_config(capacity_log2=12, points=request.param == "points")
    return request.param, chip_smoke.claim_captures(torch, cfg, chip_smoke.simulate(1.0, "claim"), 4)


@pytest.mark.cuda
def test_claim_kernel_matches_plain_on_fleet_calls_on_card(claim_fleet_calls):
    """Every captured call: the kernel's table (but its sentinel row),
    slots and flags ``torch.equal`` to claim_plain's; each call claims
    slots, and the first frame's rows are insert_points' (point, level) rows."""
    import chip_smoke

    path, calls = claim_fleet_calls
    assert [tag for tag, _ in calls] == ["first_frame", "step1", "step2"]
    for tag, cap in calls:
        same, n = chip_smoke.claim_check(torch, cap)
        assert same, (path, tag, n)
        assert n["claimed"] > 0 and n["active"] > 0, (path, tag, n)
        if tag != "first_frame" and path == "fused":
            assert n["rows"] == 4 * 4096
    assert calls[0][1][2].shape[0] == 3 * 8192  # fleet_init's pad, at every level


def _claim_case_on_card(name, dev):
    import numpy as np
    from test_torch_claim import case

    ptab_x, keys, seg, active, c, p, r = case(name, np.random.default_rng(7))
    return (ptab_x.to(dev), keys.to(dev), seg.to(dev), active.to(dev), c, p, r)


def _kernel_equals_plain(args):
    """chip_smoke.claim_check on ``args`` (bit-equal), one launch counted."""
    import chip_smoke
    from legkilo_torch.ops import claim_slots as cl

    n0 = cl.claim_call.launches
    same, n = chip_smoke.claim_check(torch, args)
    assert same, n
    assert cl.claim_call.launches == n0 + 1
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one_slot_windows", "full_windows", "duplicates", "scene", "fleet"])
def test_claim_kernel_matches_plain_on_card(cuda_device, name):
    """tests/test_torch_claim.py's cases (duplicate keys, windows that fill
    so claims fail, inactive rows, a fleet's segments) on the card: bit for
    bit, the same failed claims; two launches bit-equal."""
    import chip_smoke

    from legkilo_torch.ops import claim_slots as cl

    chip_smoke.phase_build()
    args = _claim_case_on_card(name, cuda_device)
    n = _kernel_equals_plain(args)
    assert n["failed"] > 0 if name in ("one_slot_windows", "full_windows") else n["claimed"] > 0
    once, again = (cl.claim_call(args[0].clone(), *args[1:]) for _ in range(2))
    assert torch.equal(once[0], again[0]) and torch.equal(once[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [0, 1, 6])
@pytest.mark.parametrize("probe", [1, 8])
def test_claim_kernel_each_rounds_and_probe_on_card(cuda_device, rounds, probe):
    """A crowded fleet table (half full), inactive rows, repeated keys; the
    keys, segments and flags handed over as strided views, as the gated
    rows hand their segments over."""
    import numpy as np

    from test_torch_claim import table

    rng = np.random.default_rng(11)
    ptab_x = table(4, 64, rng, 0.5).to(cuda_device)
    m = 3000
    wide = torch.from_numpy(rng.integers(-6, 6, size=(m, 7)).astype(np.int32)).to(cuda_device)
    keys = wide[:, 1:4]
    seg = torch.from_numpy(rng.integers(0, 4, size=(m, 2))).to(cuda_device)[:, 1]
    active = torch.from_numpy(rng.random((m, 3)) < 0.8).to(cuda_device)[:, 0]
    assert not (keys.is_contiguous() or seg.is_contiguous() or active.is_contiguous())
    _kernel_equals_plain((ptab_x, keys, seg, active, 64, probe, rounds))


@pytest.mark.cuda
def test_claim_kernel_takes_no_rows_on_card(cuda_device):
    """M = 0: no launch, the table untouched, empty outputs."""
    import chip_smoke

    chip_smoke.phase_build()
    args = _claim_case_on_card("scene", cuda_device)
    ptab_x = args[0]
    none = (args[1][:0], args[2][:0], args[3][:0])
    tab = ptab_x.clone()
    from legkilo_torch.ops import claim_slots as cl

    n0 = cl.claim_call.launches
    slot, ok = cl.claim_call(tab, *none, 256, 4, 2)
    assert cl.claim_call.launches == n0 and slot.shape == ok.shape == (0,)
    assert torch.equal(tab, ptab_x)


@pytest.mark.cuda
def test_claim_call_refuses_bad_input_on_card(cuda_device):
    """Each refusal comes before any launch and leaves the counter as it
    was: a wrong dtype or device, a table not [S, 5] or not contiguous,
    slots that are not whole segments, a capacity that is not a power of
    two, probe 0, negative rounds, round-tagged bids past int32."""
    from legkilo_torch.ops import claim_slots as cl

    ptab_x, keys, seg, active, c, p, r = _claim_case_on_card("scene", cuda_device)
    n0 = cl.claim_call.launches
    bad = [
        ((ptab_x.long(), keys, seg, active, c, p, r), "dtype"),
        ((ptab_x, keys.long(), seg, active, c, p, r), "dtype"),
        ((ptab_x, keys, seg.int(), active, c, p, r), "dtype"),
        ((ptab_x, keys, seg, active.to(torch.uint8), c, p, r), "dtype"),
        ((ptab_x, keys.cpu(), seg, active, c, p, r), "cuda"),
        ((ptab_x, keys, seg, active.cpu(), c, p, r), "cuda"),
        ((ptab_x.T.contiguous().T, keys, seg, active, c, p, r), "contiguous"),
        ((ptab_x[:, :4].contiguous(), keys, seg, active, c, p, r), "expected"),
        ((ptab_x[:-2].contiguous(), keys, seg, active, c, p, r), "whole"),
        ((ptab_x, keys, seg, active, 48, p, r), "power of two"),
        ((ptab_x, keys[:-1], seg, active, c, p, r), "must be"),
        ((ptab_x, keys, seg, active, c, 0, r), "probe"),
        ((ptab_x, keys, seg, active, c, p, -1), "rounds"),
        ((ptab_x, keys[:1].expand(2 ** 28, 3), seg[:1].expand(2 ** 28), active[:1].expand(2 ** 28),
          c, p, 8), "2\\^31"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            cl.claim_call(*args)
        assert cl.claim_call.launches == n0, match
    cl.claim_call(ptab_x.clone(), keys, seg, active, c, p, r)
    torch.cuda.synchronize()
    assert cl.claim_call.launches == n0 + 1


def _traced_calls(fn):
    """(device operations, host runtime calls) of ``fn`` under one
    torch.profiler window of the card's activity (portbench.phases)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import phases

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return phases.split_events(phases.events_of(prof))


def _synchronising(calls, name="Synchronize"):
    """The host's runtime calls of a trace whose name holds ``name``."""
    return [c for c in calls if name in c[0]]


@pytest.mark.cuda
def test_claim_call_does_not_synchronise_on_card(cuda_device):
    """A claim series queues one memset and 2 x rounds + 1 kernels and
    waits for nothing: no synchronising runtime call between its first
    and its last launch in a profiler trace."""
    import chip_smoke

    chip_smoke.phase_build()
    from legkilo_torch.ops import claim_slots as cl

    ptab_x, keys, seg, active, c, p, r = _claim_case_on_card("fleet", cuda_device)
    cl.claim_call(ptab_x.clone(), keys, seg, active, c, p, r)  # the library loaded
    for _ in range(3):  # a window that lost device events is taken again (_profiled_kernels)
        tab = ptab_x.clone()
        ops, calls = _traced_calls(lambda: cl.claim_call(tab, keys, seg, active, c, p, r))
        kernels = [o for o in ops if "claim_" in o[0]]
        if len(kernels) >= 2 * r + 1:
            break
    assert len(kernels) == 2 * r + 1, [o[0] for o in ops]
    mine = {o[3] for o in kernels}
    launch_times = [x[1] for x in calls if x[3] in mine]
    assert len(launch_times) == len(kernels)
    assert not [x for x in _synchronising(calls) if min(launch_times) <= x[1] <= max(launch_times)]


@pytest.mark.cuda
def test_fleet_map_equal_on_kernel_and_plain_claims_on_card(cuda_device, monkeypatch):
    """A fused fleet of 4 (3 levels of 2^12 slots, probe 8, 6 rounds) from
    its first frames through two steps, once on the claim kernel and once
    with claim_plain in its place: every map table ``torch.equal``, and a
    step synchronises no more often on the kernel (sync-debug warnings of
    the second step, counted in a profiler trace)."""

    import chip_smoke
    from legkilo_torch.core import voxel_map
    from legkilo_torch.core.filter_fleet import replica
    from legkilo_torch.io.dataset import to_device_packet
    from legkilo_torch.ops import claim_slots as cl
    from legkilo_torch.parallel.sweep import broadcast_packets, make_fleet_step, perturb_params

    chip_smoke.phase_build()
    cfg = chip_smoke.claim_config(capacity_log2=12)
    data = chip_smoke.simulate(1.0, "claim")

    def fleet_maps():
        scfg, carry, params1, seqs = chip_smoke.fleet_start(torch, cfg, [data] * 4)
        params = perturb_params(replica(params1, 0), 4, scale=chip_smoke.FLEET_NOISE, seed=0)
        step = make_fleet_step(scfg)
        pks = [broadcast_packets(to_device_packet(pk, "cuda"), 4) for pk in seqs[0][:2]]
        carry, _, _ = step(carry, pks[0], params)
        out = []
        _, calls = _traced_calls(lambda: out.append(step(carry, pks[1], params)))
        return out[0][0].vm, len(_synchronising(calls, "cudaStreamSynchronize"))

    n0 = cl.claim_call.launches
    on_kernel, syncs_kernel = fleet_maps()
    assert cl.claim_call.launches == n0 + 4 + 2  # four first frames, two steps
    monkeypatch.setattr(voxel_map, "claim_call", cl.claim_plain)
    on_plain, syncs_plain = fleet_maps()
    assert cl.claim_call.launches == n0 + 6
    for f in ("ptab", "meta", "mom", "moms", "plane", "ocnt"):
        assert torch.equal(getattr(on_kernel, f), getattr(on_plain, f)), f
    assert int((on_kernel.ptab[..., 3] > 0).sum()) > 0
    assert 0 < syncs_kernel <= syncs_plain, (syncs_kernel, syncs_plain)  # the step's list copies


# ------------------------------------------------------------- the probe --

PROBE_CASES = ["b1_l1_p8", "b3_l3_p8", "b3_l3_p1", "b1_l3_p8_f16", "b3_l1_p8_bf16", "edges_p8", "edges_p1",
               "edges_p8_bf16"]


def _probe_case_on_card(name, dev):
    """tests/test_torch_probe_planes.py's case on the card, compute dtype f32."""
    import numpy as np
    from test_torch_probe_planes import CASES

    assert sorted(CASES) == sorted(PROBE_CASES)
    ptab, plane, keys_t, idx0_t, c, p = CASES[name](np.random.default_rng(7))
    return ptab.to(dev), plane.to(dev), keys_t.to(dev), idx0_t.to(dev), c, p, torch.float32


def _probe_equals_plain(args):
    """The kernel on ``args`` ``torch.equal`` to probe_planes_plain (every
    output, with its dtype and shape), one launch counted; a second launch
    bit-equal to the first.  Returns the plain version's outputs."""
    from legkilo_torch.ops import probe_planes as pr

    n0 = pr.probe_planes_call.launches
    got = pr.probe_planes_call(*args)
    assert pr.probe_planes_call.launches == n0 + 1
    want = pr.probe_planes_plain(*args)
    for name, a, b in zip(("plane_t", "flags_t", "slot", "found", "isp"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
    again = pr.probe_planes_call(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_planes_kernel_matches_plain_on_card(cuda_device, name):
    """The CPU file's cases (fleets of 1 and 3, levels 1 and 3, windows of
    1 and 8, f32/f16/bf16 planes, the edge rows: a wrapping window, a key
    at offset probe - 1, past an empty slot, twice in a window, words on an
    empty slot, beyond the window) on the card: bit for bit."""
    import chip_smoke

    chip_smoke.phase_build()
    _probe_equals_plain(_probe_case_on_card(name, cuda_device))


def _probe_cell_config(cell):
    """A fused cell's match: ``go1_imu`` chip_smoke.probe_config (2^16
    slots a level); ``go1_kin`` configs/leg_fusion.yaml on the fused path as
    the cell runs it (NB 64, P 128, K 4, 2^17 slots a level), the five
    switches on, caps of 4,096 and 4,096 gated insert rows."""
    import chip_smoke

    if cell == "go1_imu":
        return chip_smoke.probe_config()
    cfg = chip_smoke.sim_cli_config("configs/leg_fusion.yaml")
    cfg.voxel_map.insert_row_cap = chip_smoke.PROBE_CAP
    for k in ("use_pallas", "use_pallas_match", "use_pallas_insert", "use_pallas_pose", "use_pallas_refit"):
        setattr(cfg.tpu, k, True)
    return cfg


def _probe_tile(cap, b, bb):
    """A captured probe call of ``b`` replicas tiled to ``bb`` (a multiple
    of b): the tables repeated, and each copy's rows probing its own copy."""
    ptab, plane, keys_t, idx0_t, c, p, dtype = cap
    k = bb // b
    shift = torch.arange(k, dtype=torch.int32, device=idx0_t.device).repeat_interleave(idx0_t.shape[1])
    return (ptab.repeat(k, 1), plane.repeat(k, 1), keys_t.repeat(1, k),
            idx0_t.repeat(1, k) + shift * ptab.shape[0], c, p, dtype)


@pytest.fixture(scope="module", params=["go1_imu", "go1_kin"])
def probe_cell_calls(request):
    """The probe calls of a fleet of 4 replicas of the bench sim at a
    fused cell's map and caps (``_probe_cell_config``), one a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    import chip_smoke
    from legkilo_torch.core import filter_deferred

    chip_smoke.phase_build()
    kin = request.param == "go1_kin"
    data = chip_smoke.simulate(chip_smoke.CLAIM_DURATION_S, "probe")
    return request.param, chip_smoke.fleet_captures(
        torch, _probe_cell_config(request.param), data, 4, (filter_deferred, "probe_planes_call"),
        use_kin=kin)


@pytest.mark.cuda
def test_probe_planes_kernel_at_the_fused_cells_shapes_on_card(probe_cell_calls):
    """Each step's call tiled to the cell's fleet (go1_imu 256 replicas,
    1,048,576 rows, 3 x 2^16 slots each; go1_kin 128, 524,288 rows, 3 x 2^17
    slots each), every copy probing its own tables: bit for bit, two
    launches bit-equal, hits and misses among the candidates."""
    cell, calls = probe_cell_calls
    b_cell, slots = (256, 2 ** 16) if cell == "go1_imu" else (128, 2 ** 17)
    assert [tag for tag, _ in calls] == ["step1", "step2"]
    for tag, cap in calls:
        big = _probe_tile(cap, 4, b_cell)
        assert big[3].shape == (6, b_cell * 4096) and big[0].shape[0] == b_cell * 3 * slots, tag
        want = _probe_equals_plain(big)
        hits = int(want[1][:6].sum())
        assert 0 < hits < big[3].numel(), (cell, tag, hits)
        del big, want
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_probe_planes_call_refuses_bad_input_on_card(cuda_device):
    """Each refusal comes before any launch and leaves the counter as it
    was: a wrong dtype or device, a table not [S, 5] / [S, 31] or not
    contiguous, slots that are not whole subtables, a capacity that is not
    a power of two, a probe outside [1, C], keys or starts of the wrong
    shape or not contiguous, a compute dtype other than f32, key words
    past int32."""
    from legkilo_torch.ops import probe_planes as pr

    ptab, plane, keys_t, idx0_t, c, p, dt = _probe_case_on_card("b3_l3_p8", cuda_device)
    n0 = pr.probe_planes_call.launches
    big_r = 2 ** 27
    bad = [
        ((ptab.long(), plane, keys_t, idx0_t, c, p, dt), "dtype"),
        ((ptab, plane.double(), keys_t, idx0_t, c, p, dt), "dtype"),
        ((ptab, plane, keys_t.long(), idx0_t, c, p, dt), "dtype"),
        ((ptab, plane, keys_t, idx0_t.long(), c, p, dt), "dtype"),
        ((ptab, plane.cpu(), keys_t, idx0_t, c, p, dt), "cuda"),
        ((ptab, plane, keys_t.cpu(), idx0_t, c, p, dt), "cuda"),
        ((ptab.T.contiguous().T, plane, keys_t, idx0_t, c, p, dt), "contiguous"),
        ((ptab, plane, keys_t.T.contiguous().T, idx0_t, c, p, dt), "contiguous"),
        ((ptab[:, :4].contiguous(), plane, keys_t, idx0_t, c, p, dt), "expected"),
        ((ptab, plane[:, :30].contiguous(), keys_t, idx0_t, c, p, dt), "expected"),
        ((ptab[:-1].contiguous(), plane[:-1].contiguous(), keys_t, idx0_t, c, p, dt), "whole"),
        ((ptab, plane, keys_t, idx0_t, 48, p, dt), "power of two"),
        ((ptab, plane, keys_t, idx0_t, c, 0, dt), "probe"),
        ((ptab, plane, keys_t, idx0_t, c, c + 1, dt), "probe"),
        ((ptab, plane, keys_t[:-1], idx0_t, c, p, dt), "keys_t"),
        ((ptab, plane, keys_t, idx0_t[:-1], c, p, dt), "idx0_t"),
        ((ptab, plane, keys_t, idx0_t, c, p, torch.float64), "float32"),
        ((ptab, plane, keys_t[:, :1].expand(18, big_r), idx0_t[:, :1].expand(6, big_r), c, p, dt),
         "2\\^31"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            pr.probe_planes_call(*args)
        assert pr.probe_planes_call.launches == n0, match
    pr.probe_planes_call(ptab, plane, keys_t, idx0_t, c, p, dt)
    torch.cuda.synchronize()
    assert pr.probe_planes_call.launches == n0 + 1


@pytest.mark.cuda
def test_probe_planes_call_is_one_kernel_and_waits_for_nothing_on_card(cuda_device):
    """A call a plane storage (f32, f16, bf16) under one profiler window:
    each queues exactly one device operation, probe_planes_kernel of its
    storage, and no synchronising runtime call lies between the first
    launch and the last."""
    import chip_smoke

    from legkilo_torch.ops import probe_planes as pr

    chip_smoke.phase_build()
    cases = [_probe_case_on_card(n, cuda_device) for n in ("b3_l3_p8", "b1_l3_p8_f16", "b3_l1_p8_bf16")]
    for args in cases:  # the library loaded
        pr.probe_planes_call(*args)
    for _ in range(3):  # a window that lost device events is taken again (_profiled_kernels)
        n0 = pr.probe_planes_call.launches
        ops, calls = _traced_calls(lambda: [pr.probe_planes_call(*a) for a in cases])
        if len(ops) >= 3:
            break
    assert pr.probe_planes_call.launches == n0 + 3
    names = [o[0] for o in ops]
    assert len(ops) == 3 and all("probe_planes_kernel" in n for n in names), names
    assert ["<float>" in names[0], "__half" in names[1], "__nv_bfloat16" in names[2]] == [True] * 3, names
    mine = {o[3] for o in ops}
    launch_times = [x[1] for x in calls if x[3] in mine]
    assert len(launch_times) == 3
    assert not [x for x in _synchronising(calls) if min(launch_times) <= x[1] <= max(launch_times)]
