"""The port's copies of the JAX package's library functions that the main
path does not run, against the JAX package on the CPU: the sim's stress
worlds (corridor, floor, cluttered with its bounded facets), SO(3)'s log,
Euler angles and quaternion, the state's boxplus/boxminus, the dense
point sufficient statistics and the first packet's IMU means; then the
port's deferred pipeline on the cluttered world within
tests/test_cluttered_world.py's bounds (the non-planar regime: L0 voxels
that refuse a plane fit, planar L1 children inside them).
"""

import numpy as np
import pytest
import torch

from legkilo_torch import config as t_config
from legkilo_torch.core import eskf_fused as t_ef
from legkilo_torch.core import so3 as t_so3
from legkilo_torch.core import state as t_state
from legkilo_torch.io import dataset as t_dataset
from legkilo_torch.models import sim as t_sim
from legkilo_torch.runner import OdometryRunner
from torch_util import N, T, one_thread  # noqa: F401


def _rotations(rng, n, scale):
    """n rotations Exp(w), w ~ N(0, scale^2) a component (float64 -> f32)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(scale=scale, size=(n, 3))).as_matrix().astype(np.float32)


def _same_sim(a, b):
    assert len(a.scans) == len(b.scans) and len(a.imu) == len(b.imu)
    for sa, sb in zip(a.scans, b.scans):
        assert sa.begin_time == sb.begin_time and sa.end_time == sb.end_time
        np.testing.assert_array_equal(sa.points, sb.points)
        np.testing.assert_array_equal(sa.time_offset, sb.time_offset)
    for ea, eb in zip(a.imu, b.imu):
        assert ea.time == eb.time
        np.testing.assert_array_equal(ea.acc, eb.acc)
        np.testing.assert_array_equal(ea.gyr, eb.gyr)
    for ka, kb in zip(a.kin, b.kin):
        for f in ("foot_pos", "foot_vel", "contact"):
            np.testing.assert_array_equal(getattr(ka, f), getattr(kb, f))
    for f in ("gt_times", "gt_rot", "gt_pos", "mean_acc", "mean_gyr"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("world", ["corridor", "floor", "cluttered"])
def test_stress_worlds_equal_the_jax_sim(world):
    """``simulate`` on each world (1 s, 1,200 points, seed 4; the cluttered
    world from seed 7, its facet branch of the raycast included) gives the
    JAX sim's scans, events and ground truth, array for array."""
    from legkilo_tpu.models import sim as j_sim

    make = {"corridor": lambda m: m.corridor_world(), "floor": lambda m: m.floor_world(),
            "cluttered": lambda m: m.cluttered_world(seed=7)}[world]
    cfg = dict(duration=1.0, scan_points=1200, seed=4)
    traj = dict(speed=0.8, z0=1.0, roll_amp=0.05, pitch_amp=0.03)
    got = t_sim.simulate(t_sim.SimConfig(**cfg), world=make(t_sim), traj=t_sim.Trajectory(**traj))
    want = j_sim.simulate(j_sim.SimConfig(**cfg), world=make(j_sim), traj=j_sim.Trajectory(**traj))
    _same_sim(got, want)
    assert sum(len(s.points) for s in got.scans) > 1000
    if world == "cluttered":
        facets = [f for f in t_sim.cluttered_world(seed=7) if isinstance(f, t_sim.Facet)]
        assert len(facets) > 200


def test_log_so3_matches_jax():
    """log_so3 of 64 rotations at 0.5 rad and 64 near the identity (the
    Taylor branch): the JAX function's within 1e-6 absolute (f32)."""
    import jax.numpy as jnp

    from legkilo_tpu.core import so3 as j_so3

    rng = np.random.default_rng(1)
    rots = np.concatenate([_rotations(rng, 64, 0.5), _rotations(rng, 64, 1e-7)])
    got = N(t_so3.log_so3(T(rots)))
    want = np.asarray(j_so3.log_so3(jnp.asarray(rots)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # And it inverts exp_so3 where the angle is well inside (0, pi).
    w = rng.normal(scale=0.4, size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(N(t_so3.log_so3(t_so3.exp_so3(T(w)))), w, atol=2e-6)


def test_rot_to_euler_and_quat_from_rot_match_jax():
    """ZYX Euler angles and Shepperd's quaternion of 128 rotations at 1.5
    rad (each of the four quaternion branches taken) and of a singular
    pitch of pi/2: the JAX functions' within 1e-6 absolute (f32)."""
    import jax.numpy as jnp

    from legkilo_tpu.core import so3 as j_so3

    rng = np.random.default_rng(2)
    rots = _rotations(rng, 128, 1.5)
    c, s = 0.0, 1.0
    rots = np.concatenate([rots, np.array([[[c, 0, s], [0, 1, 0], [-s, 0, c]]], np.float32)])
    np.testing.assert_allclose(N(t_so3.rot_to_euler(T(rots))),
                               np.asarray(j_so3.rot_to_euler(jnp.asarray(rots))), atol=1e-6)
    q = N(t_so3.quat_from_rot(T(rots)))
    np.testing.assert_allclose(q, np.asarray(j_so3.quat_from_rot(jnp.asarray(rots))), atol=1e-6)
    m = rots
    mags = np.stack([m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2], m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                     m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2], m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1]], 1)
    assert set(np.argmax(mags, axis=1).tolist()) == {0, 1, 2, 3}
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)


def test_boxplus_and_boxminus_match_jax():
    """boxplus (the one core/eskf.py runs) and boxminus on 32 random states
    and 30-dim deltas: the JAX functions' within 1e-6 absolute; boxminus
    undoes boxplus to 2e-6."""
    import jax.numpy as jnp

    from legkilo_tpu.core import state as j_state
    from legkilo_torch.core import eskf as t_eskf

    assert t_eskf.boxplus is t_state.boxplus
    rng = np.random.default_rng(3)
    rot = _rotations(rng, 32, 1.0)
    lin = rng.normal(size=(32, 27)).astype(np.float32)
    dx = (0.2 * rng.normal(size=(32, 30))).astype(np.float32)
    ts = t_state.State(rot=T(rot), lin=T(lin))
    js = j_state.State(rot=jnp.asarray(rot), lin=jnp.asarray(lin))
    tp = t_state.boxplus(ts, T(dx))
    jp = j_state.boxplus(js, jnp.asarray(dx))
    np.testing.assert_allclose(N(tp.rot), np.asarray(jp.rot), atol=1e-6)
    np.testing.assert_allclose(N(tp.lin), np.asarray(jp.lin), atol=1e-6)
    got = N(t_state.boxminus(tp, ts))
    np.testing.assert_allclose(got, np.asarray(j_state.boxminus(jp, js)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, dx, atol=2e-6)


def test_dense_point_suffstats_matches_jax_and_the_compact_form():
    """The dense [NB, P] statistics of 2 x 4 buckets of 24 points (a third
    unmatched) equal the JAX function's to f32 rounding (rtol 1e-5 of each
    bucket's largest entry) and the compact form's on the same rows."""
    import jax.numpy as jnp

    from legkilo_tpu.core import eskf_fused as j_ef

    rng = np.random.default_rng(4)
    shape = (2, 4, 24)
    p = rng.normal(scale=3.0, size=shape + (3,)).astype(np.float32)
    n = rng.normal(size=shape + (3,)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    c = rng.normal(size=shape + (3,)).astype(np.float32)
    r = rng.uniform(1e-3, 1e-2, size=shape).astype(np.float32)
    m = rng.uniform(size=shape) > 0.33
    got = N(t_ef.point_suffstats(T(p), T(n), T(c), T(r), T(m)))
    want = np.asarray(j_ef.point_suffstats(*(jnp.asarray(x) for x in (p, n, c, r, m))))
    assert got.shape == (2, 4, 40, 40)
    scale = np.abs(want).max(axis=(-1, -2), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
    bidx = torch.arange(8).repeat_interleave(24)
    compact = N(t_ef.point_suffstats_compact(*(T(x).reshape((-1,) + x.shape[3:])
                                               for x in (p, n, c, r, m)), bidx, 8))
    np.testing.assert_allclose(got.reshape(8, 40, 40) / scale.reshape(8, 1, 1),
                               compact / scale.reshape(8, 1, 1), atol=1e-5)


def test_first_packet_imu_stats_matches_jax():
    from legkilo_tpu.io import dataset as j_dataset

    data = t_sim.simulate(t_sim.SimConfig(duration=0.5, scan_points=200, seed=5))
    for got, want in zip(t_dataset.first_packet_imu_stats(data.imu[:25]),
                         j_dataset.first_packet_imu_stats(data.imu[:25])):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_dataset.first_packet_imu_stats(data.imu[:25])[0], data.mean_acc)


# ------------------------------------------- the cluttered world, end to end --


def clutter_cfg(five=False):
    """tests/test_cluttered_world.py's ``make_cfg("deferred")`` in the
    port's Config; ``five``: with all five kernel switches on (their plain
    versions here)."""
    cfg = t_config.Config()
    cfg.only_imu_use = True
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    cfg.lidar.voxel_grid_resolution = 0.2
    cfg.voxel_map.capacity_log2 = 14
    cfg.voxel_map.max_layer = 2
    cfg.tpu.max_buckets = 56
    cfg.tpu.max_points_per_bucket = 128
    cfg.tpu.max_imu_per_bucket = 3
    cfg.tpu.pipeline = "deferred"
    if five:
        cfg.tpu.use_pallas = cfg.tpu.use_pallas_match = cfg.tpu.use_pallas_insert = True
        cfg.tpu.use_pallas_pose = cfg.tpu.use_pallas_refit = True
    return cfg


@pytest.fixture(scope="module")
def clutter_data():
    """tests/test_cluttered_world.py's data: 4 s, 2,000 points, seed 3, on
    cluttered_world(seed=7), with its trajectory."""
    traj = t_sim.Trajectory(speed=0.8, z0=1.0, roll_amp=0.05, pitch_amp=0.03, bob=0.03)
    return t_sim.simulate(t_sim.SimConfig(duration=4.0, scan_points=2000, seed=3),
                          world=t_sim.cluttered_world(seed=7), traj=traj)


def clutter_run(cfg, data, device="cpu"):
    """The port's runner streamed over ``data`` as the JAX test's ``_replay``
    feeds it: (runner, per-scan position errors, mean match rate after 5)."""
    runner = OdometryRunner(cfg, device=device)
    ev = iter(data.imu)
    pending = next(ev, None)
    for scan in data.scans:
        while pending is not None and pending.time <= scan.end_time + 0.5:
            runner.add_imu(pending)
            pending = next(ev, None)
        runner.add_scan(scan)
    runner.flush()
    _, gt = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    errs = np.array([np.linalg.norm(r.pos - gt[gtm[round(r.time, 6)]])
                     for r in runner.results if round(r.time, 6) in gtm])
    rate = float(np.mean([r.n_matched / max(r.n_points, 1) for r in runner.results[5:]]))
    return runner, errs, rate


def nonplanar_counts(runner):
    """(non-planar L0 voxels, non-planar L0 parents holding a planar L1 child)."""
    vm = runner.carry.vm
    c = runner.scfg.map_cfg.capacity
    meta, ptab = N(vm.meta), N(vm.ptab)
    nonplane0 = (meta[:c, 2] > 0) & ~(ptab[:c, 4] > 0)
    keys0 = {tuple(k) for k in ptab[:c][nonplane0, 0:3]}
    plane1 = (meta[c:2 * c, 2] > 0) & (ptab[c:2 * c, 4] > 0)
    parents = {tuple(k) for k in np.floor_divide(ptab[c:2 * c][plane1, 0:3], 2)}
    return int(nonplane0.sum()), len(keys0 & parents)


@pytest.mark.parametrize("five", [False, True], ids=["deferred", "five_kernels"])
def test_cluttered_world_within_the_jax_bounds(clutter_data, five):
    """The port's deferred pipeline (kernel switches off, and all five on:
    their plain versions) on the cluttered world: at least 12 non-planar L0
    voxels, at least 5 of them with planar L1 children, RMS error < 0.05
    m, final error < 0.06 m, mean match rate > 0.6."""
    runner, errs, rate = clutter_run(clutter_cfg(five), clutter_data)
    nonplanar, parents = nonplanar_counts(runner)
    assert nonplanar >= 12, nonplanar
    assert parents >= 5, parents
    assert errs[-1] < 0.06, errs[-1]
    assert np.sqrt((errs ** 2).mean()) < 0.05
    assert rate > 0.6, rate
