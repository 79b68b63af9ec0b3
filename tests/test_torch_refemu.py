"""The port against the reference-semantics emulator (tools/refemu), on the CPU.

Twins of three tests of tests/test_refemu_parity.py, with the port's CPU
path where those run the JAX package, at the same bounds:

* with every deviation toggle at the accelerator-side semantics, the
  emulator reproduces the port's sequential trajectory (< 1 cm RMSE,
  < 3 cm max) and its deferred path with all five kernel switches on
  (< 2 cm RMSE, < 5 cm max);
* in kin + IMU mode, the emulator at the reference's own semantics tracks
  ground truth and the port's sequential trajectory agrees with it at the
  centimetre level (< 3 cm RMSE): tests/test_torch_refemu_kin.py, a file
  of its own so that the test runs beside this file's on another worker.

The emulator runs once per sim and semantics (module fixtures); it is used
as it is, on the port's own sim streams.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

from legkilo_torch.config import Config          # noqa: E402
from legkilo_torch.models import sim             # noqa: E402
from legkilo_torch.runner import run_offline     # noqa: E402
from refemu.emulator import EmuParams, run_emulator  # noqa: E402
from torch_util import one_thread  # noqa: E402,F401


def _cfg(only_imu=True):
    """tests/test_refemu_parity.py's configuration."""
    cfg = Config()
    cfg.only_imu_use = only_imu
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    cfg.lidar.voxel_grid_resolution = 0.4
    cfg.voxel_map.capacity_log2 = 14
    cfg.voxel_map.max_layer = 2
    cfg.tpu.max_buckets = 56
    cfg.tpu.max_points_per_bucket = 96
    cfg.tpu.max_imu_per_bucket = 3
    return cfg


def _tpu_toggles(p: EmuParams) -> EmuParams:
    """Every deviation toggle at the accelerator-side semantics."""
    p.point_update = "information"
    p.neighbor_retry = "fixed"
    p.insert_timing = "scan_end"
    p.requantize_after_downsample = True
    p.init_imu_a_from_grav = True
    return p


@pytest.fixture(scope="module")
def short_sim():
    traj = sim.Trajectory(speed=0.8, roll_amp=0.05, pitch_amp=0.03, bob=0.03)
    return sim.simulate(sim.SimConfig(duration=4.0, scan_points=2000, seed=3), traj=traj)


@pytest.fixture(scope="module")
def emu_toggled(short_sim):
    """The emulator at the accelerator-side semantics, IMU mode."""
    return run_emulator(short_sim.scans, short_sim.imu, _tpu_toggles(EmuParams.from_config(_cfg(True))))


def _gt_ate(data, times, poss):
    _, gt_pos = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    sel = [i for i, t in enumerate(times) if round(t, 6) in gtm]
    idx = [gtm[round(times[i], 6)] for i in sel]
    return float(np.sqrt(np.mean(np.sum((poss[sel] - gt_pos[idx]) ** 2, axis=1))))


def _distances(results, emu):
    """Per-scan distance between the port's and the emulator's positions."""
    times, _, poss, _ = emu
    rm = {round(r.time, 6): r.pos for r in results}
    pairs = [(poss[i], rm[round(t, 6)]) for i, t in enumerate(times) if round(t, 6) in rm]
    assert len(pairs) >= 30
    return np.array([np.linalg.norm(a - b) for a, b in pairs])


def test_tpu_toggles_reproduce_port_trajectory(short_sim, emu_toggled):
    """The sequential pipeline (the JAX package's default)."""
    results = run_offline(_cfg(True), short_sim.scans, short_sim.imu, device="cpu")
    d = _distances(results, emu_toggled)
    rmse = float(np.sqrt((d ** 2).mean()))
    assert rmse < 0.01, f"emulator(tpu-all) vs port rmse {rmse:.4f} m"
    assert d.max() < 0.03, f"max divergence {d.max():.4f} m"


def test_tpu_toggles_reproduce_deferred_kernel_trajectory(short_sim, emu_toggled):
    """The deferred pipeline with all five kernel switches on (the port's
    plain versions of the kernels here); the predicted-pose match adds its
    deviation, so the budget is the JAX test's wider one."""
    cfg = _cfg(True)
    tp = cfg.tpu
    tp.pipeline = "deferred"
    tp.use_pallas = tp.use_pallas_match = tp.use_pallas_insert = True
    tp.use_pallas_pose = tp.use_pallas_refit = True
    tp.match_cap = tp.insert_cap = 2560
    cfg.voxel_map.insert_row_cap = 2560
    results = run_offline(cfg, short_sim.scans, short_sim.imu, device="cpu")
    d = _distances(results, emu_toggled)
    rmse = float(np.sqrt((d ** 2).mean()))
    assert rmse < 0.02, f"emulator(tpu-all) vs deferred+kernels rmse {rmse:.4f} m"
    assert d.max() < 0.05, f"max divergence {d.max():.4f} m"
