"""The port's deferred main path end to end vs the JAX package, on the CPU.

Both run the same sim scans through the same packetizer and the deferred
pipeline with the chain, match and insert kernels on (JAX in interpret
mode; the port on its plain versions).  Also: resuming a JAX checkpoint in
the port, the CLI without JAX importable, the options the port refuses and
those it runs, and no silent CPU fallback.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from legkilo_tpu import config as j_config
from legkilo_tpu import runner as j_runner
from legkilo_tpu.core import filter as j_filter
from legkilo_tpu.core import filter_deferred as j_fd
from legkilo_tpu.io import checkpoint as j_ckpt
from legkilo_tpu.io import dataset as j_ds
from legkilo_tpu.models import sim as j_sim

import legkilo_torch
from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch import runner as t_runner
from legkilo_torch.core import filter as t_filter
from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.io import dataset as t_ds
from torch_util import N, assert_maps_match, cloned, one_thread  # noqa: F401

CAPACITY_LOG2 = 11
N_SCANS = 8
_JAX_STEP = jax.jit(j_fd.process_scan_deferred, static_argnums=3)


def make_cfg(mod, use_kin=False, five=False):
    """A small cut of the bench workload on the kernel path: 4 ms buckets,
    K = 1, three levels of 2^11 slots, one claim round, caps of 1024 rows.
    ``five`` turns the pose and refit kernels on as well (bench.py's set)."""
    cfg = mod.Config()
    cfg.only_imu_use = not use_kin
    cfg.lidar.filter_num = 2
    cfg.lidar.blind = 0.3
    cfg.lidar.voxel_grid_resolution = 0.4
    vm = cfg.voxel_map
    vm.capacity_log2, vm.insert_rounds, vm.probe_length = CAPACITY_LOG2, 1, 4
    vm.insert_row_cap, vm.refit_budget = 1024, 512
    tp = cfg.tpu
    tp.bucket_quantum_ms, tp.max_buckets, tp.max_points_per_bucket = 4.0, 28, 64
    tp.max_imu_per_bucket, tp.insert_cap, tp.match_cap = 1, 1024, 1024
    tp.pipeline = "deferred"
    tp.use_pallas = tp.use_pallas_match = tp.use_pallas_insert = True
    tp.use_pallas_pose = tp.use_pallas_refit = five
    tp.use_native = False  # the port builds packets with the numpy path
    return cfg


def build_packets(ds, cfg, data, use_kin=False):
    b = ds.PacketBuilder(cfg)
    for ev in (data.kin if use_kin else data.imu):
        (b.add_kin_imu if use_kin else b.add_imu)(ev)
    raws, pkts = [], []
    for scan in data.scans:
        b.add_scan(scan)
        while b.ready():
            raws.append(b._scans[0])
            pkts.append(b.pop())
    return raws, pkts


def run_both(use_kin, n_scans, keep=(), with_spread=False, match_iters=1, five=False):
    """Init (first-frame state and map) and ``n_scans`` deferred steps on
    both sides; returns per-scan outputs and carries at the ``keep`` steps."""
    data = j_sim.simulate(j_sim.SimConfig(duration=(n_scans + 2) * 0.1, scan_points=2500, seed=11))
    jcfg, tcfg = make_cfg(j_config, use_kin, five), make_cfg(t_config, use_kin, five)
    jcfg.tpu.match_iters = tcfg.tpu.match_iters = match_iters
    jraw, jp = build_packets(j_ds, jcfg, data, use_kin)
    traw, tp = build_packets(t_ds, tcfg, data, use_kin)
    jr = j_runner.OdometryRunner(jcfg)
    tr = t_runner.OdometryRunner(tcfg, device="cpu")
    jr._initialize(jraw[0], jp[0])
    tr._initialize(traw[0], tp[0])
    out = dict(jp=jp, tp=tp, jr=jr, tr=tr, init=(jr.carry, cloned(tr.carry)), steps=[], kept={},
               spread=[], data=data)
    jc, tc, xc = jr.carry, tr.carry, jr.carry
    # The JAX package's own spread: its XLA path (kernels off) from the same
    # state, an equivalent computation rounded differently.
    xla = jr.scfg._replace(use_pallas=False, use_pallas_match=False, use_pallas_insert=False,
                           use_pallas_pose=False,
                           map_cfg=jr.scfg.map_cfg._replace(use_pallas_refit=False))
    for i in range(1, n_scans + 1):
        jpk = j_ds.to_device_packet(jp[i])
        jc, jo = _JAX_STEP(jc, jpk, jr.params, jr.scfg)
        tc, to = t_fd.process_scan_deferred(tc, t_ds.to_device_packet(tp[i], "cpu"), tr.params, tr.scfg)
        out["steps"].append((jax.tree.map(np.asarray, jo), to))
        if with_spread:
            xc, xo = _JAX_STEP(xc, jpk, jr.params, xla)
            out["spread"].append(float(np.abs(np.asarray(xo.pos) - np.asarray(jo.pos)).max()))
        if i in keep:
            out["kept"][i] = (jc, cloned(tc))
    out["final"] = (jc, tc)
    return out


@pytest.fixture(scope="module")
def imu_run():
    return run_both(False, N_SCANS, keep=(3,), with_spread=True)


def test_packets_match_jax(imu_run):
    assert len(imu_run["jp"]) >= N_SCANS + 1
    for a, b in zip(imu_run["jp"], imu_run["tp"]):
        for f in ("rebase", "end_offset", "bucket_time", "bucket_mask", "points", "point_mask",
                  "imu_time", "imu_mask", "imu_acc", "imu_gyr", "foot_pos", "foot_vel", "contact"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        tp = t_ds.to_device_packet(b, "cpu")
        assert tp.points.dtype == torch.float32 and tp.point_mask.dtype == torch.bool


def test_first_frame_state_and_map_match_jax(imu_run):
    jc, tc = imu_run["init"]
    np.testing.assert_allclose(N(tc.state.lin), np.asarray(jc.state.lin), atol=1e-6)
    np.testing.assert_array_equal(N(tc.state.rot), np.asarray(jc.state.rot))
    np.testing.assert_allclose(float(imu_run["tr"].params.g_over_acc_norm),
                               float(imu_run["jr"].params.g_over_acc_norm), rtol=1e-6)
    np.testing.assert_allclose(float(tc.last_predict_t), float(jc.last_predict_t), atol=1e-7)
    # The full claim path (insert_points): same slots, keys and moments.
    assert_maps_match(jc.vm, tc.vm, 1 << CAPACITY_LOG2)


def test_slice_tracks_jax_scan_by_scan(imu_run):
    """Poses per scan and matches track JAX.  The first step from the same
    map agrees to rounding (5e-5 m).  Later the two part: while the robot
    starts moving the map holds near-collinear voxels whose f32 normals are
    undetermined, and rounding differences feed back through the map.  The
    JAX package's own two paths (kernels on / off, the same algebra) part
    the same way, by ~2 mm after 8 scans on this sim; the bound is 4x that
    spread so far, plus 0.1 mm."""
    spread = np.maximum.accumulate(imu_run["spread"])
    for i, (jo, to) in enumerate(imu_run["steps"], start=1):
        tol = 4 * spread[i - 1] + 1e-4
        np.testing.assert_allclose(N(to.pos), jo.pos, atol=tol, err_msg=f"scan {i}")
        np.testing.assert_allclose(N(to.rot), jo.rot, atol=tol, err_msg=f"scan {i}")
        assert int(N(to.n_points)) == int(jo.n_points)
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= max(3, 0.03 * int(jo.n_matched))
        if i == 1:
            np.testing.assert_allclose(N(to.pos), jo.pos, atol=5e-5)
            np.testing.assert_array_equal(int(N(to.n_matched)), int(jo.n_matched))
    assert int(imu_run["steps"][-1][0].n_matched) > 100  # the map is in use
    assert spread[-1] < 1e-2
    # Maps after N_SCANS: the same voxels but for the few whose points moved
    # across a face with the pose difference above.
    jc, tc = imu_run["final"]
    kj = {tuple(k) for k in sorted_keys(jc.vm)}
    kt = {tuple(k) for k in sorted_keys(tc.vm)}
    assert len(kj & kt) >= 0.98 * max(len(kj), len(kt))


def sorted_keys(vm):
    from torch_util import sorted_map_rows

    return sorted_map_rows(vm, 1 << CAPACITY_LOG2)[0]


def test_resume_jax_checkpoint(imu_run, tmp_path):
    """A JAX checkpoint after scan 3, loaded into the port, steps scans 4
    and 5 like the JAX carry does."""
    jc3, _ = imu_run["kept"][3]
    path = j_ckpt.save(str(tmp_path / "ckpt"), jc3, step=4,
                       extras={"g_over_acc_norm": np.asarray(imu_run["jr"].params.g_over_acc_norm)})
    tc, step, extras = convert.load_jax_checkpoint(path, "cpu")
    assert step == 4 and float(extras["g_over_acc_norm"]) == float(imu_run["jr"].params.g_over_acc_norm)
    for a, b in zip(convert.carry_to_numpy(tc), jax.tree.leaves(jc3)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tr, jr = imu_run["tr"], imu_run["jr"]
    tparams = convert.params_from_numpy([np.asarray(x) for x in jax.tree.leaves(jr.params)], "cpu")
    jc = jc3
    for i in (4, 5):
        jc, jo = _JAX_STEP(jc, j_ds.to_device_packet(imu_run["jp"][i]), jr.params, jr.scfg)
        tc, to = t_fd.process_scan_deferred(tc, t_ds.to_device_packet(imu_run["tp"][i], "cpu"),
                                            tparams, tr.scfg)
        if i == 4:  # one step from the same map: the same map after it, by key
            assert_maps_match(jc.vm, tc.vm, 1 << CAPACITY_LOG2, exact_slots=False, mom_rtol=1e-4)
        # One step from the same state: rounding only, compounded over 2 scans.
        np.testing.assert_allclose(N(to.pos), np.asarray(jo.pos), atol=2e-4)
        np.testing.assert_allclose(N(to.rot), np.asarray(jo.rot), atol=2e-4)
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= 2
        np.testing.assert_array_equal(N(to.map_overflow)[1], np.asarray(jo.map_overflow)[1])


def test_kin_slice_tracks_jax():
    """Leg-kinematic mode (the 18-row update in the chain) for 3 scans."""
    run = run_both(True, 3)
    for i, (jo, to) in enumerate(run["steps"], start=1):
        np.testing.assert_allclose(N(to.pos), jo.pos, atol=1e-3, err_msg=f"scan {i}")
        np.testing.assert_allclose(N(to.rot), jo.rot, atol=1e-3, err_msg=f"scan {i}")
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= max(3, 0.03 * int(jo.n_matched))


def test_iterated_matching_tracks_jax():
    """match_iters = 2 (the escalation latch switches to 3): re-match at the
    first chain pass's bucket poses, re-run the chain from the scan start."""
    run = run_both(False, 3, match_iters=2)
    for i, (jo, to) in enumerate(run["steps"], start=1):
        tol = 5e-5 if i == 1 else 1e-3
        np.testing.assert_allclose(N(to.pos), jo.pos, atol=tol, err_msg=f"scan {i}")
        np.testing.assert_allclose(N(to.rot), jo.rot, atol=tol, err_msg=f"scan {i}")
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= max(3, 0.03 * int(jo.n_matched))


def _spliced(sim_mod, dataset_mod, after: int, gap: float):
    """A short sim whose streams jump ``gap`` seconds after scan ``after``."""
    import dataclasses

    data = sim_mod.simulate(sim_mod.SimConfig(duration=0.9, scan_points=2000, seed=5))
    t_cut = data.scans[after].end_time
    scans = [dataclasses.replace(s, begin_time=s.begin_time + gap, end_time=s.end_time + gap)
             if i > after else s for i, s in enumerate(data.scans)]
    events = [dataclasses.replace(e, time=e.time + gap) if e.time > t_cut else e for e in data.imu]
    return scans, events


def test_run_offline_gap_reset_matches_jax(caplog):
    """run_offline on both packages over a 20 s sensor gap: both soft-reset
    (tpu_gap_reset_s = 10 s) and produce the same scans and poses."""
    from legkilo_torch.models import sim as t_sim

    jcfg, tcfg = make_cfg(j_config), make_cfg(t_config)
    jres = j_runner.run_offline(jcfg, *_spliced(j_sim, j_ds, 4, 20.0))
    tres = t_runner.run_offline(tcfg, *_spliced(t_sim, t_ds, 4, 20.0), device="cpu")
    assert caplog.text.count("soft reset") >= 2
    assert [r.time for r in tres] == [r.time for r in jres]
    assert [r.n_points for r in tres] == [r.n_points for r in jres]
    # Nine scans from the robot starting to move: the packages part by
    # millimetres (see test_slice_tracks_jax_scan_by_scan), so 1 cm here.
    for rt, rj in zip(tres, jres):
        np.testing.assert_allclose(rt.pos, rj.pos, atol=1e-2)
        np.testing.assert_allclose(rt.rot, rj.rot, atol=1e-2)


def test_soft_reset_matches_jax(rng):
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    lin = rng.normal(size=27).astype(np.float32)
    jc = j_filter.init_carry(j_runner.make_static_config(make_cfg(j_config)))
    jc = jc._replace(state=jc.state._replace(rot=jax.numpy.asarray(rot), lin=jax.numpy.asarray(lin)))
    tc = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jc)], "cpu")
    a = j_filter.soft_reset_carry(jc, 12.5)
    b = t_filter.soft_reset_carry(tc, 12.5)
    for x, y in zip(convert.carry_to_numpy(b), jax.tree.leaves(a)):
        np.testing.assert_allclose(x, np.asarray(y), atol=1e-6)


def test_cli_sim_runs_without_jax():
    """``python -m legkilo_torch sim --device cpu`` with jax unimportable: the
    JAX command's default, ``Config()`` on the sequential pipeline."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['legkilo_tpu'] = None\n"
        "sys.argv = ['legkilo_torch', 'sim', '--device', 'cpu', '--duration', '0.8',"
        " '--scan_points', '1500']\n"
        "runpy.run_module('legkilo_torch', run_name='__main__', alter_sys=True)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(line) == {"scans", "ate_rmse_m", "wall_s", "ms_per_scan"}
    assert line["scans"] >= 6 and line["ate_rmse_m"] < 0.08


def test_cli_config_file_off_the_port_path_raises(tmp_path):
    """A config file runs as written: one that sets a value no path of the
    port takes is refused, not switched onto another path."""
    from legkilo_torch import cli

    path = tmp_path / "off.yaml"
    path.write_text("tpu_pipeline: deferred\ntpu_match_pose: spline\n")
    with pytest.raises(NotImplementedError, match="match_pose"):
        cli.main(["sim", "--device", "cpu", "--config_file", str(path),
                  "--duration", "0.3", "--scan_points", "500"])


@pytest.mark.parametrize("change", [
    ("tpu", "match_pose", "spline"), ("tpu", "chain_impl", "pallas"), ("tpu", "dtype", "float64"),
])
def test_unported_options_raise(change):
    cfg = make_cfg(t_config)
    section, key, value = change
    setattr(getattr(cfg, section), key, value)
    with pytest.raises(NotImplementedError):
        t_runner.OdometryRunner(cfg, device="cpu")


@pytest.mark.parametrize("change", [
    ("tpu", "use_pallas_pose", True), ("tpu", "use_pallas_refit", True),
    ("tpu", "match_pose", "const_vel"), ("voxel_map", "map_sliding_en", True),
    ("tpu", "chain_impl", "jax"),
    ("tpu", "pipeline", "sequential"), ("tpu", "use_pallas", False),
    ("tpu", "use_pallas_match", False), ("tpu", "use_pallas_insert", False),
    ("tpu", "match_cap", 1100), ("voxel_map", "insert_row_cap", 1000),
])
def test_ported_options_run(change):
    """The options this package used to refuse: a runner takes each and
    steps a few scans to a finite pose that has matched points."""
    from legkilo_torch.models import sim as t_sim

    cfg = make_cfg(t_config)
    section, key, value = change
    setattr(getattr(cfg, section), key, value)
    cfg.voxel_map.sliding_thresh, cfg.voxel_map.half_map_size = 0.01, 6   # the slide fires
    data = t_sim.simulate(t_sim.SimConfig(duration=0.5, scan_points=2000, seed=5))
    res = t_runner.run_offline(cfg, data.scans, data.imu, device="cpu")
    assert len(res) >= 4 and np.isfinite(res[-1].pos).all() and res[-1].n_matched > 100


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_runner.OdometryRunner(make_cfg(t_config), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        legkilo_torch.resolve_device("cuda")
    assert legkilo_torch.resolve_device("cpu").type == "cpu"


def test_escalation_latch_and_collapse_alarm(caplog):
    r = t_runner.OdometryRunner(make_cfg(t_config), device="cpu")
    assert r._scfg_active.match_iters == 1
    for _ in range(20):
        r._n_done += 1
        r._watch_match_rate(0.1)
    assert r._esc_active and r._scfg_active.match_iters == 3
    assert "auto-escalating" in caplog.text and "may have diverged" in caplog.text
    for _ in range(10):  # sticky by default (deescalate_after = 0)
        r._n_done += 1
        r._watch_match_rate(0.95)
    assert r._esc_active
