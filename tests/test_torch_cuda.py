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


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    import chip_smoke

    chip_smoke.phase_build()
    recs = chip_smoke.phase_kernels(torch, cuda_device)
    assert set(recs) == {"chain_stats", "chain_stats_kin", "chain_points", "chain_points_kin",
                         "keys", "select", "moments", "fit", "pose", "pose_384"}


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
    with pytest.raises(ValueError, match="multiple of 128"):   # one block: MP <= 1024
        pp.pose_call(par, torch.zeros(9, 1152, device=cuda_device))
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
    assert torch.allclose(pp.pose_call(*pargs), pp.pose_plain(*pargs), rtol=1e-5, atol=1e-6)


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
    sg = match_geom.select_call(*sargs, 2, 5)
    sr = match_geom.select_plain(*sargs, 2, 5)
    same = sg[0][0] == sr[0][0]
    assert float(same.float().mean()) >= 0.99
    e_s40, nm_same = cs.select_sums_vs_plain(torch, *sg, *sr, sargs[7], 5)
    assert e_s40 <= 1e-4 and nm_same

    margs = cs.moments_inputs(torch, cuda_device, rng, r=300)
    assert cs.rel_err(insert_rows.moments_call(*margs), insert_rows.moments_plain(*margs)) <= 1e-4


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
