"""Helpers shared by the tests/test_torch_*.py files (no tests here)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs with several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    """numpy (or JAX) array -> C-contiguous CPU tensor (a copy)."""
    return torch.from_numpy(np.array(x, order="C"))


def N(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sorted_map_rows(vm, capacity):
    """Occupied slots sorted by (level, key): keys, ptab rows, and the
    meta/mom/moms/plane rows as float64."""
    ptab = N(vm.ptab)
    idx = np.nonzero(ptab[:, 3] > 0)[0]
    key = np.concatenate([(idx // capacity)[:, None], ptab[idx, 0:3]], axis=1)
    order = np.lexsort(key.T[::-1])
    rows = [N(t)[idx][order].astype(np.float64) for t in (vm.meta, vm.mom, vm.moms, vm.plane)]
    return key[order], ptab[idx][order], rows


def assert_maps_match(jvm, tvm, capacity, exact_slots=True, mom_rtol=1e-5):
    """Maps equal by key: same keys and probe rows, counts and flags exact,
    moments to f32 rounding, planes where the fit is well conditioned."""
    np.testing.assert_array_equal(N(tvm.ocnt), np.asarray(jvm.ocnt))
    if exact_slots:
        np.testing.assert_array_equal(N(tvm.ptab), np.asarray(jvm.ptab))
    kj, pj, (mj, oj, sj, lj) = sorted_map_rows(jvm, capacity)
    kt, pt, (mt, ot, st, lt) = sorted_map_rows(tvm, capacity)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(pt, pj)          # is_plane mirror included
    np.testing.assert_array_equal(mt, mj)          # counts and flags: exact
    # Moment sums of <= 50 points: f32 rounding of the products and sums.
    np.testing.assert_allclose(ot, oj, rtol=mom_rtol, atol=1e-6)
    np.testing.assert_allclose(st, sj, rtol=10 * mom_rtol, atol=1e-9)
    # Planes: centre, evals, radius to rounding; the normal up to sign and
    # the 6x6 covariance only where the fit is well conditioned
    # (lam_mid > 1e-3): near-collinear voxels leave the normal undetermined
    # in f32 and the covariance divides by the eigenvalue gaps.
    np.testing.assert_allclose(lt[:, 0:3], lj[:, 0:3], atol=1e-5)
    np.testing.assert_allclose(lt[:, 6:10], lj[:, 6:10], atol=1e-5)
    good = (lj[:, 7] > 1e-3) & (mj[:, 3] > 0.5)
    dots = np.abs(np.sum(lt[good, 3:6] * lj[good, 3:6], axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    scale = np.abs(lj[good, 10:31]).max(axis=1, keepdims=True) + 1e-30
    np.testing.assert_allclose(lt[good, 10:31] / scale, lj[good, 10:31] / scale, atol=2e-3)


# A small cut of the bench workload on the five-kernel deferred path, for
# ``run`` on a bag: 4 ms buckets, K = 1, P = 64, three levels of 2^12 slots,
# one claim round, caps of 1024 rows, one match pass a scan (the latch off).
BAG_RUN_YAML = """\
only_imu_use: {only_imu_use}
redundancy: false
filter_num: 1
blind: 0.3
voxel_grid_resolution: 0.4
tpu_map_capacity_log2: 12
tpu_map_insert_rounds: 1
tpu_map_probe_length: 4
tpu_map_insert_row_cap: 1024
tpu_map_refit_budget: 512
tpu_bucket_quantum_ms: 4.0
tpu_max_buckets: 28
tpu_max_points_per_bucket: 64
tpu_max_imu_per_bucket: 1
tpu_insert_cap: 1024
tpu_match_cap: 1024
tpu_escalate_after: 0
tpu_pipeline: deferred
tpu_use_pallas: {kernels}
tpu_use_pallas_match: {kernels}
tpu_use_pallas_insert: {kernels}
tpu_use_pallas_pose: {kernels}
tpu_use_pallas_refit: {kernels}
"""


def write_bag_run(directory, use_kin, duration=2.0, kernels=True):
    """A ``duration`` s sim (2,500 points a scan; seed 6 with leg
    kinematics, else 5, as tests/test_bag_e2e.py) written as a ROS1 bag by
    chip_smoke's writer (Imu or HighState messages, and PointCloud2 with
    intensity, stamps + 1000 s), its ground truth as TUM, and the
    configuration above (``kernels`` off: every kernel switch off).
    Returns (bag path, config path, ground-truth path, sim data)."""
    import chip_smoke as cs
    from legkilo_torch.config import KinematicsConfig
    from legkilo_torch.models import sim

    data = sim.simulate(sim.SimConfig(duration=duration, scan_points=2500, seed=6 if use_kin else 5))
    msgs = cs.kin_bag_messages(data, KinematicsConfig()) if use_kin else cs.imu_bag_messages(data)
    tag = "kin" if use_kin else "imu"
    bag, cfg, gt = (str(directory / f"{tag}{ext}") for ext in (".bag", ".yaml", "_gt.txt"))
    cs.write_bag(bag, msgs)
    cs.write_gt_tum(gt, data)
    with open(cfg, "w") as f:
        f.write(BAG_RUN_YAML.format(only_imu_use=str(not use_kin).lower(),
                                    kernels=str(kernels).lower()))
    return bag, cfg, gt, data


def bag_ate(traj_path, data, max_dt=0.01):
    """(ATE without alignment, pairs) of a TUM trajectory of a bag run
    against the sim's ground truth, associated by nearest time (the bag
    path takes a scan's end time from its last point's stamp)."""
    from legkilo_torch.io.tum import associate, ate_rmse, read_tum

    t, p, _ = read_tum(traj_path)
    _, gt = data.gt_in_filter_frame()
    ia, ib = associate(t, data.gt_times + 1000.0, max_dt=max_dt)
    return ate_rmse(p[ia], gt[ib], align=False), len(ia)
