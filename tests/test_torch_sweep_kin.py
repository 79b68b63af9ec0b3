"""``sweep`` on a kinematic configuration (``only_imu_use: false``), on the CPU.

``python -m legkilo_torch sweep`` runs the configuration it is given: on a
kinematic yaml its fleet fuses the leg kinematics (``use_kin`` on, the
sim's kin events in the packets), and its poses are the library fleet's
(``make_fleet_step`` on packets built from the kin events), bit for bit; on
an ``only_imu_use: true`` yaml it is the IMU fleet it always was.
``--distinct 2`` runs the kinematic fleet too.  The fused kinematic fleet
at leg_fusion.yaml's 2 ms shape (NB 64, P 128, K 4; the benchmark's cell
``go1_kin.mc128`` cut to 2 replicas and 0.6 s) agrees with the benchmark's
float64 reference within the cell's limits, and the chain's counters
(``chain.kin_slots``, ``chain_kin.launches``) count from shapes, with no
read of a device value.  The case marked ``cuda`` counts the kernel's
launch on the card.  Tiny sizes: 4 replicas, 1.5 s, 2^10 slots a level.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from legkilo_torch import cli as t_cli
from legkilo_torch import config as t_config
from legkilo_torch.core.filter_fleet import tree_map
from legkilo_torch.io.dataset import PacketBuilder, to_device_packet
from legkilo_torch.models import sim as t_sim
from legkilo_torch.parallel import sweep as t_sw
from legkilo_torch.runner import make_params, make_static_config
from legkilo_torch.utils import timing
from torch_util import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, DURATION = 4, 1.5
TINY_YAML = """\
voxel_grid_resolution: 0.4
tpu_map_capacity_log2: 10
tpu_map_insert_rounds: 1
tpu_map_probe_length: 4
tpu_map_insert_row_cap: 512
tpu_map_refit_budget: 256
tpu_max_buckets: 8
tpu_max_points_per_bucket: 128
tpu_max_imu_per_bucket: 1
tpu_insert_cap: 512
tpu_match_cap: 512
"""
FIVE = ("use_pallas", "use_pallas_match", "use_pallas_insert", "use_pallas_pose", "use_pallas_refit")


def _yaml(tmp_path_factory, only_imu_use: bool) -> str:
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(TINY_YAML + f"only_imu_use: {str(only_imu_use).lower()}\n")
    return str(path)


def _recording_step(monkeypatch, rec: dict):
    """``make_fleet_step`` as ``sweep`` calls it, recording the static
    config, each packet and each step's poses."""
    real = t_sw.make_fleet_step

    def make(scfg, mesh=None, with_stats=True):
        rec["scfg"] = scfg
        step = real(scfg, mesh=mesh, with_stats=with_stats)

        def recorded(carry, packet, params):
            carry, out, stats = step(carry, packet, params)
            rec["packets"].append(packet)
            rec["pos"].append(out.pos.clone())
            return carry, out, stats

        return recorded

    rec.update(scfg=None, packets=[], pos=[])
    monkeypatch.setattr(t_sw, "make_fleet_step", make)


def _sweep(argv):
    """``sweep`` in this process: its report."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _broadcast_run(yaml_path):
    """``sweep --replicas B`` on the five-kernel fused path: (report, record)."""
    rec = {}
    with pytest.MonkeyPatch.context() as mp:
        _recording_step(mp, rec)
        report = _sweep(["sweep", "--device", "cpu", "--replicas", str(B), "--duration",
                         str(DURATION), "--pipeline", "deferred", "--pallas", "--config_file",
                         yaml_path])
    return report, rec


def _library_fleet(yaml_path, use_kin: bool, today: bool = False):
    """The library's broadcast fleet on ``sweep``'s sim, built by hand: the
    packets from the kin events (``use_kin``) or the Imu events, the empty
    filter copied to B, ``q_diag`` jittered as ``sweep`` jitters it, one
    ``make_fleet_step`` a packet (g/|acc| from the sim's ``mean_acc``, the
    kin events' force too).  ``today`` builds the IMU fleet as ``sweep``
    built it before it read ``only_imu_use`` (use_kin forced off).  Returns
    (packets, poses)."""
    cfg = t_config.load(yaml_path)
    cfg.lidar.filter_num, cfg.lidar.blind = 1, 0.3
    cfg.tpu.pipeline = "deferred"
    for k in FIVE:
        setattr(cfg.tpu, k, True)
    data = t_sim.simulate(t_sim.SimConfig(duration=DURATION))
    scfg = make_static_config(cfg, use_kin=False) if today else make_static_config(cfg)
    assert scfg.use_kin == use_kin
    builder = PacketBuilder(cfg)
    for ev in (data.kin if use_kin else data.imu):
        (builder.add_kin_imu if use_kin else builder.add_imu)(ev)
    packets = []
    for scan in data.scans:
        builder.add_scan(scan)
        while builder.ready():
            packets.append(builder.pop())
    params = make_params(cfg, "cpu", float(cfg.gravity / np.linalg.norm(data.mean_acc)))
    carry = t_sw.batched_carry(scfg, B, "cpu")
    bparams = t_sw.perturb_params(params, B, scale=0.1)
    step = t_sw.make_fleet_step(scfg)
    devs = [t_sw.broadcast_packets(to_device_packet(p, "cpu"), B) for p in packets]
    poses = []
    for dev in devs:
        carry, out, _ = step(carry, dev, bparams)
        poses.append(out.pos)
    return devs, poses


@pytest.fixture(scope="module")
def kin_sweep(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = _yaml(tmp_path_factory, only_imu_use=False)
        return path, _broadcast_run(path)
    finally:
        torch.set_num_threads(n)


def test_sweep_on_a_kin_yaml_runs_the_kin_fleet(kin_sweep):
    """``use_kin`` is on and every packet holds kinematic event slots:
    contacts, foot positions and velocities, the same in each replica."""
    _, (report, rec) = kin_sweep
    assert report["replicas"] == B and np.isfinite(report["final_spread_m"])
    assert rec["scfg"].use_kin and rec["scfg"].chain_impl == "fused"
    assert rec["scfg"].map_cfg.capacity == 1 << 10
    assert len(rec["packets"]) == report["scans"] + 3  # the 3 warm-up steps
    contacts = sum(int((p.contact & p.imu_mask[..., None]).sum()) for p in rec["packets"])
    feet = sum(float(p.foot_pos[p.imu_mask].abs().sum()) for p in rec["packets"])
    assert contacts > 0 and feet > 0
    for p in rec["packets"]:
        assert tuple(p.foot_pos.shape[:3]) == (B, 8, 1) and tuple(p.contact.shape) == (B, 8, 1, 4)
        assert torch.equal(p.foot_pos[0], p.foot_pos[-1])


def test_sweep_kin_poses_equal_the_library_fleet(kin_sweep):
    """Each step's poses are ``torch.equal`` to the library fleet's on
    packets built from the sim's kin events, and so are the packets."""
    path, (_, rec) = kin_sweep
    devs, poses = _library_fleet(path, use_kin=True)
    assert len(poses) == len(rec["pos"])
    for want, got in zip(devs, rec["packets"]):
        assert all(torch.equal(a, b) for a, b in zip(want, got) if a is not None)
    for want, got in zip(poses, rec["pos"]):
        assert torch.equal(want, got)


def test_sweep_imu_yaml_gives_todays_fleet(tmp_path_factory):
    """With ``only_imu_use: true`` the fleet is the IMU fleet that ``sweep``
    ran before it read the flag: the same packets and poses, bit for bit."""
    path = _yaml(tmp_path_factory, only_imu_use=True)
    _, rec = _broadcast_run(path)
    assert not rec["scfg"].use_kin
    assert all(not bool(p.contact.any()) for p in rec["packets"])
    devs, poses = _library_fleet(path, use_kin=False, today=True)
    for want, got in zip(devs, rec["packets"]):
        assert all(torch.equal(a, b) for a, b in zip(want, got) if a is not None)
    assert len(poses) == len(rec["pos"])
    for want, got in zip(poses, rec["pos"]):
        assert torch.equal(want, got)


def test_sweep_distinct_runs_the_kin_fleet(tmp_path_factory):
    """``--distinct 2`` on the kinematic yaml: the fleet fuses the legs
    (``use_kin``, contacts in the stacked packets) and each replica tracks
    its own world's ground truth."""
    path = _yaml(tmp_path_factory, only_imu_use=False)
    rec = {}
    with pytest.MonkeyPatch.context() as mp:
        _recording_step(mp, rec)
        report = _sweep(["sweep", "--device", "cpu", "--distinct", "2", "--duration", "1.0",
                         "--pipeline", "deferred", "--pallas", "--config_file", path])
    assert rec["scfg"].use_kin and report["replicas"] == 2 and report["scans"] >= 8
    assert sum(int((p.contact & p.imu_mask[..., None]).sum()) for p in rec["packets"]) > 0
    assert any(not torch.equal(p.foot_pos[0], p.foot_pos[1]) for p in rec["packets"])
    assert all(a < 0.08 for a in report["ate_per_replica_m"].values()), report


def _scalar_reads(fn) -> int:
    """How many times ``fn`` reads a tensor's value to the host
    (``aten._local_scalar_dense``: ``.item()``, ``int()``, ``bool()``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def test_chain_kin_slots_count_from_shapes(kin_sweep):
    """Under ``record_spans`` a kinematic fleet step tallies B x NB x K
    ``chain.kin_slots`` (one match pass a step) under ``lk.chain``, and
    recording reads no more device values than a step without it."""
    path, (_, rec) = kin_sweep
    scfg, devs = rec["scfg"], rec["packets"][:2]
    carry = t_sw.batched_carry(scfg, B, "cpu")
    params = t_sw.perturb_params(make_params(t_config.load(path), "cpu"), B)
    step = t_sw.make_fleet_step(scfg)

    def run():
        c = tree_map(lambda x: x.clone(), carry)
        for dev in devs:
            c, _, _ = step(c, dev, params)

    off = _scalar_reads(run)
    with timing.record_spans() as spans:
        on = _scalar_reads(run)
    assert on == off
    nb, k = devs[0].imu_time.shape[-2:]
    assert spans.counters["chain.kin_slots"] == len(devs) * B * nb * k
    assert "chain_kin.launches" not in spans.counters  # the plain chain launches no kernel
    assert sum(s[0] == "lk.chain" for s in spans) == len(devs)


def test_fused_kin_fleet_at_the_yaml_shape_agrees_with_the_reference():
    """The benchmark's cell ``go1_kin.mc128`` (leg_fusion.yaml: NB 64, P
    128, K 4, 2 ms buckets, 2^17 slots, kin on, five kernel switches) cut
    to 2 replicas and 0.6 s of sequence: the fleet's sampled calls against
    the float64 reference are within the cell's limits (``correct``)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import check, harness

    cell = "go1_kin.mc128"
    res = harness.run_cell(ROOT, cell, 2**31 + 11, 0.5, False, "cpu", time.perf_counter(),
                           overrides={"replicas": 2, "sequence_s": 0.6, "scan_points": 8000})
    settings = harness.manifest.Manifest(ROOT).config("go1_kin")["settings"]
    assert (settings["tpu_max_buckets"], settings["tpu_max_points_per_bucket"],
            settings["tpu_max_imu_per_bucket"], settings["only_imu_use"]) == (64, 128, 4, False)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["checks"]) == set(check.load_limits(ROOT, cell))


@pytest.mark.cuda
def test_chain_kin_counters_on_card():
    """On the card a fused kinematic fleet step at NB 64, K 4 (B = 4)
    tallies one ``chain_kin.launches`` and B x NB x K ``chain.kin_slots``,
    and launches ``chain_warp_kernel<true>`` once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from legkilo_torch.ops import chain_stats

    cfg = t_config.load(os.path.join(ROOT, "configs", "leg_fusion.yaml"))
    cfg.lidar.filter_num, cfg.lidar.blind = 1, 0.3
    cfg.voxel_map.capacity_log2 = 14
    cfg.voxel_map.insert_row_cap = 4096
    for k in FIVE:
        setattr(cfg.tpu, k, True)
    scfg = make_static_config(cfg)
    data = t_sim.simulate(t_sim.SimConfig(duration=0.4, scan_points=8000))
    builder = PacketBuilder(cfg)
    for ev in data.kin:
        builder.add_kin_imu(ev)
    packets = []
    for scan in data.scans:
        builder.add_scan(scan)
        while builder.ready():
            packets.append(builder.pop())
    dev = torch.device("cuda")
    carry = t_sw.batched_carry(scfg, B, dev)
    params = t_sw.perturb_params(make_params(cfg, dev), B)
    step = t_sw.make_fleet_step(scfg)
    devs = [t_sw.broadcast_packets(to_device_packet(p, dev), B) for p in packets[:2]]
    carry, _, _ = step(carry, devs[0], params)
    n0 = chain_stats.chain_call.launches
    with timing.record_spans() as spans:
        carry, out, _ = step(carry, devs[1], params)
    torch.cuda.synchronize()
    assert chain_stats.chain_call.launches == n0 + 1
    assert spans.counters["chain_kin.launches"] == 1
    assert spans.counters["chain.kin_slots"] == B * 64 * 4
    assert bool(torch.isfinite(out.pos).all())
