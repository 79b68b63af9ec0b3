"""The port's fleet (``legkilo_torch/parallel/sweep.py``, ``sweep``) on the CPU.

The seven kernels take a replica axis: each plain version at B = 3 equals
three B = 1 calls.  The fleet step equals the single steps replica by
replica (bit for bit on the five-kernel route; the sequential pipeline's
one batched step within the tolerances of its batched ESKF products; the
other routes in tests/test_torch_fleet_routes.py), chunked equals per-scan
stepping,
and the fleet tracks the JAX package's ``make_fleet_step`` (its XLA arm,
the bounds of tests/test_fleet_pallas.py).  The CLI's ``sweep`` runs
``--distinct``, ``--bags`` and ``--traj_out`` with ``--device cpu``, and its
fleet checkpoint resumes to the uninterrupted run and reads the JAX CLI's
file.  The tests marked ``cuda`` repeat the kernel and fleet checks on the
card; the file imports JAX only inside the tests that compare with it, so
on a machine without JAX the card tests run with

    python3 -m pytest --noconftest tests/test_torch_fleet.py -q -m cuda

The small configuration is tests/test_fleet_pallas.py's ``_build`` (2^11
slots a level, NB 8, P 128, caps 512) with all five kernel switches on.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from legkilo_torch import cli as t_cli
from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch.core import eskf as t_eskf
from legkilo_torch.core import filter as t_filter
from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.core.filter import FilterParams, ScanPacket, process_scan_any
from legkilo_torch.core.filter_fleet import replica
from legkilo_torch.io.dataset import decimate_blind, to_device_packet
from legkilo_torch.io.tum import read_tum
from legkilo_torch.models import sim as t_sim
from legkilo_torch.parallel import sweep as t_sw
from legkilo_torch.runner import make_static_config
from torch_util import N, one_thread  # noqa: F401

SMALL_YAML = """\
voxel_grid_resolution: 0.4
tpu_map_capacity_log2: 11
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


def small_cfg(five=True, pipeline="deferred"):
    """tests/test_fleet_pallas.py's ``_build`` in the port's Config, with
    all five kernel switches on (``five``) or none."""
    cfg = t_config.Config()
    cfg.only_imu_use = True
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    cfg.lidar.voxel_grid_resolution = 0.4
    cfg.voxel_map.capacity_log2 = 11
    cfg.voxel_map.insert_row_cap = 512
    cfg.tpu.max_buckets = 8
    cfg.tpu.max_points_per_bucket = 128
    cfg.tpu.max_imu_per_bucket = 1
    cfg.tpu.pipeline = pipeline
    cfg.tpu.insert_cap = 512
    cfg.tpu.match_cap = 512
    for k in FIVE:
        setattr(cfg.tpu, k, five)
    return cfg


def params_of(cfg):
    return FilterParams(noise=t_eskf.make_noise_params(cfg.eskf, "cpu"), ext_r=torch.eye(3),
                        ext_t=torch.tensor([0.0, 0.0, 0.2]), g_over_acc_norm=torch.tensor(1.0))


def distinct_start(cfg, n, duration=0.6, scan_points=3000):
    """n distinct sims through fleet_init, as ``sweep --distinct`` starts:
    (scfg, carry, params, the replicas' device packets after the first);
    with ``only_imu_use`` off the packets carry the sims' kinematic events."""
    scfg = make_static_config(cfg)
    use_kin = not cfg.only_imu_use
    seqs, clouds, accs, gyrs, offs = [], [], [], [], []
    for r in range(n):
        data = t_sim.simulate(t_sim.SimConfig(duration=duration, scan_points=scan_points, seed=10 + r),
                              traj=t_sim.Trajectory(speed=0.5 + 0.2 * r, radius=2.0 + 0.3 * r))
        pk = t_cli._packets_from_streams(cfg, data.scans, data.kin if use_kin else data.imu,
                                         use_kin=use_kin)
        m = pk[0].imu_mask
        accs.append(pk[0].imu_acc[m].mean(axis=0))
        gyrs.append(pk[0].imu_gyr[m].mean(axis=0))
        offs.append(pk[0].end_offset)
        pts, _, _ = decimate_blind(data.scans[0].points, data.scans[0].time_offset, 1, 0.3)
        clouds.append(pts)
        seqs.append([to_device_packet(p, "cpu") for p in pk[1:]])
    carry, params = t_sw.fleet_init(scfg, params_of(cfg), clouds, np.stack(accs), np.stack(gyrs),
                                    np.asarray(offs), 9.81, device="cpu")
    return scfg, carry, params, seqs


def count_calls(monkeypatch, module, name):
    """A list that gains an entry at each call of ``module.name``."""
    calls, fn = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def assert_trees_equal(a, b):
    la, lb = [], []
    t_sw.tree_map(lambda x: la.append(x), a)
    t_sw.tree_map(lambda x: lb.append(x), b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"leaf {i}"


@pytest.mark.parametrize("kernel", ["pose", "chain_stats", "keys", "select", "moments", "fit",
                                    "chain_points", "chain_points_kin"])
def test_plain_version_of_a_fleet_equals_its_replicas(kernel):
    """Each kernel's plain version at B = 3 distinct replicas (the fleet
    layout: par a row a replica, rows and buckets side by side, indices
    global; the chains' every argument with a leading B) equals three B = 1
    calls, bit for bit."""
    cases = chip_smoke._fleet_kernel_cases(torch, "cpu", np.random.default_rng(13), 3, small=True)
    fargs, singles, call, fleet_of, _, _ = cases[kernel]
    got = call(fargs)
    want = fleet_of([call(s) for s in singles])
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(x, y), f"{kernel}: output {i}"


def test_fleet_step_on_distinct_streams_equals_single_steps(monkeypatch):
    """The port of tests/test_sharding.py's test_vmap_deferred_matches_loop
    on the five-kernel route: three distinct sims, perturbed q_diag, four
    fleet steps, each one fused step for the three replicas; every
    replica's outputs and final carry are those of its own single steps,
    bit for bit."""
    cfg = small_cfg()
    scfg, carry0, params, seqs = distinct_start(cfg, 3)
    params = t_sw.perturb_params(replica(params, 0), 3, scale=0.2, seed=1)._replace(
        g_over_acc_norm=params.g_over_acc_norm)
    steps = t_sw.stack_packets(seqs)[:4]
    step = t_sw.make_fleet_step(scfg)
    fused = count_calls(monkeypatch, t_fd, "_process_scan_fused")
    carry, outs = carry0, []
    for pk in steps:
        carry, out, stats = step(carry, pk, params)
        outs.append(out)
    monkeypatch.undo()
    assert len(fused) == len(steps)
    assert float(stats.mean_matched) > 50
    for r in range(3):
        c = replica(carry0, r)
        for k, pk in enumerate(steps):
            c, o = process_scan_any(c, replica(pk, r), replica(params, r), scfg)
            assert_trees_equal(o, replica(outs[k], r))
        assert_trees_equal(c, replica(carry, r))


def test_sequential_fleet_takes_the_replica_loop(monkeypatch):
    """The sequential pipeline's fleet takes no replica loop any more: a
    fleet of 2 over 2 scans runs each bucket once for both replicas (NB
    bucket steps a fleet step, not B x NB) and equals their single runs:
    counts and map keys and occupancy equal, and every float within the
    tolerances of the batched ESKF products (pos and rot 1e-5, covariance
    1e-6; tests/test_torch_fleet_routes.py)."""
    from test_torch_fleet_routes import assert_replica_matches, route_cfg

    cfg = route_cfg("sequential")  # small_cfg, the sequential pipeline, buckets spanning the scan
    scfg, carry0, params, seqs = distinct_start(cfg, 2, duration=0.4)
    steps = t_sw.stack_packets(seqs)[:2]
    step = t_sw.make_fleet_step(scfg, with_stats=False)
    buckets = count_calls(monkeypatch, t_filter, "_point_bucket")
    carry = carry0
    outs = []
    for pk in steps:
        carry, out, _ = step(carry, pk, params)
        outs.append(out)
    monkeypatch.undo()
    assert len(buckets) == len(steps) * steps[0].points.shape[1]
    for r in range(2):
        c = replica(carry0, r)
        for k, pk in enumerate(steps):
            c, o = process_scan_any(c, replica(pk, r), replica(params, r), scfg)
            assert_replica_matches(o, replica(outs[k], r), exact=False)
        assert_replica_matches(c, replica(carry, r), exact=False)


def test_fleet_chunk_equals_per_scan_stepping():
    """The port of tests/test_fleet_chunk.py:48: K = 4 scans a call equal
    four per-scan fleet steps (outputs stacked [B, K, ...], final carry),
    bit for bit."""
    cfg = small_cfg()
    scfg, carry0, params, seqs = distinct_start(cfg, 2, duration=1.0)
    steps = t_sw.stack_packets(seqs)[:8]
    step = t_sw.make_fleet_step(scfg)
    c1, per_scan = carry0, []
    for pk in steps:
        c1, out, _ = step(c1, pk, params)
        per_scan.append(out)
    chunk_step = t_sw.make_fleet_chunk_step(scfg)
    c2, chunked = carry0, []
    for pks in t_sw.stack_fleet_chunks(steps, 4):
        c2, outs, stats = chunk_step(c2, pks, params)
        chunked.append(outs)
    assert_trees_equal(c1, c2)
    for k, out in enumerate(per_scan):
        assert_trees_equal(out, t_sw.tree_map(lambda x: x[:, k % 4], chunked[k // 4]))
    assert torch.equal(stats.mean_pos, per_scan[-1].pos.mean(dim=0))


def test_fleet_tracks_jax_make_fleet_step(monkeypatch):
    """The port's fleet (five kernel switches, plain versions) against the
    JAX package's ``make_fleet_step`` on its XLA arm, as
    tests/test_fleet_pallas.py holds the two JAX lowerings: one map boot
    (the port's, carried to JAX leaf for leaf), params by ``convert``, four
    fleet steps of B = 2 on the same packets; pos at rtol/atol 2e-3,
    mean_matched at atol 3."""
    import jax
    import jax.numpy as jnp

    from legkilo_tpu.core import eskf as j_eskf
    from legkilo_tpu.core.filter import FilterParams as JParams
    from legkilo_tpu.io.dataset import PacketBuilder as JBuilder
    from legkilo_tpu.io.dataset import to_device_packet as j_to_device
    from legkilo_tpu.models import sim as j_sim
    from legkilo_tpu.parallel import sweep as j_sw
    from test_fleet_pallas import _build

    b = 2
    scfg_j, jcfg = _build(False)
    jparams = j_sw.perturb_params(JParams(
        noise=j_eskf.make_noise_params(jcfg.eskf), ext_r=jnp.eye(3),
        ext_t=jnp.asarray([0.0, 0.0, 0.2]), g_over_acc_norm=jnp.asarray(1.0)), b, scale=0.0)
    data = j_sim.simulate(j_sim.SimConfig(duration=0.8, scan_points=5000, seed=3))
    builder = JBuilder(jcfg)
    for ev in data.imu:
        builder.add_imu(ev)
    jdev = []
    for s in data.scans:
        builder.add_scan(s)
        while builder.ready():
            jdev.append(j_to_device(builder.pop()))
    tdev = [ScanPacket(*(torch.from_numpy(np.array(x, order="C")) for x in p)) for p in jdev]

    cfg = small_cfg()
    scfg = make_static_config(cfg)
    fused = count_calls(monkeypatch, t_fd, "_process_scan_fused")
    params = convert.params_from_numpy([np.asarray(x) for x in jax.tree.leaves(jparams)], "cpu")
    from legkilo_torch.core.filter import first_frame_map, init_carry

    one = first_frame_map(init_carry(scfg, "cpu"), scfg, replica(params, 0),
                          tdev[0].points.reshape(-1, 3), tdev[0].point_mask.reshape(-1))
    carry = t_sw.tree_map(lambda x: x.expand((b,) + tuple(x.shape)).clone(), one)
    jcarry = jax.tree.unflatten(jax.tree.structure(j_sw.batched_carry(scfg_j, b)),
                                [jnp.asarray(x) for x in convert.carry_to_numpy(carry)])

    jstep, tstep = j_sw.make_fleet_step(scfg_j), t_sw.make_fleet_step(scfg)
    for jp, tp in zip(jdev[1:5], tdev[1:5]):
        jcarry, _, jstats = jstep(jcarry, j_sw.broadcast_packets(jp, b), jparams)
        carry, _, tstats = tstep(carry, t_sw.broadcast_packets(tp, b), params)
    assert len(fused) == 4  # one fused step a fleet step
    assert float(jstats.mean_matched) > 0 and float(tstats.mean_matched) > 0
    np.testing.assert_allclose(float(tstats.mean_matched), float(jstats.mean_matched), atol=3.0)
    np.testing.assert_allclose(N(carry.state.pos), np.asarray(jcarry.state.pos), rtol=2e-3, atol=2e-3)


def test_perturb_params_draws_only_q_diag():
    """Scale 0 gives equal replicas; one seed gives the same factors twice
    and another seed others; only q_diag moves, by a factor a replica."""
    base = params_of(small_cfg())
    flat = t_sw.perturb_params(base, 4, scale=0.0)
    assert all(torch.equal(flat.noise.q_diag[r], base.noise.q_diag) for r in range(4))
    a = t_sw.perturb_params(base, 4, scale=0.3, seed=5)
    again = t_sw.perturb_params(base, 4, scale=0.3, seed=5)
    other = t_sw.perturb_params(base, 4, scale=0.3, seed=6)
    assert torch.equal(a.noise.q_diag, again.noise.q_diag)
    assert not torch.equal(a.noise.q_diag, other.noise.q_diag)
    for field in ("imu_meas_r", "kin_meas_noise", "lidar_point_meas_ratio"):
        assert torch.equal(getattr(a.noise, field), getattr(flat.noise, field))
    for field in ("ext_r", "ext_t", "g_over_acc_norm"):
        assert torch.equal(getattr(a, field), getattr(flat, field))
    nz = base.noise.q_diag > 0
    ratio = a.noise.q_diag[:, nz] / base.noise.q_diag[nz]
    assert torch.allclose(ratio, ratio[:, :1].expand_as(ratio), rtol=1e-6)
    assert float(ratio[:, 0].std()) > 0


def _sweep(capsys, argv):
    assert t_cli.main(argv) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


@pytest.fixture
def small_yaml(tmp_path):
    path = tmp_path / "small.yaml"
    path.write_text(SMALL_YAML)
    return str(path)


def test_sweep_distinct_checkpoint_resume_equivalence(tmp_path, capsys, small_yaml):
    """The port of tests/test_fleet_ckpt.py: ``sweep --distinct 2`` on the
    five-kernel path with ``--device cpu`` and ``--traj_out``; the first 4
    fleet steps chunked by 2 and checkpointed, then resumed to the stream's
    end, give the uninterrupted run's trajectories; resuming with another
    replica count raises."""
    common = ["sweep", "--device", "cpu", "--distinct", "2", "--duration", "1.0", "--pipeline",
              "deferred", "--pallas", "--config_file", small_yaml]
    full = _sweep(capsys, common + ["--traj_out", str(tmp_path / "full")])
    assert full["replicas"] == 2 and full["scans"] >= 8
    assert all(a < 0.08 for a in full["ate_per_replica_m"].values())
    h1 = _sweep(capsys, common + ["--max_steps", "4", "--chunk", "2", "--save_ckpt",
                                  str(tmp_path / "ck"), "--traj_out", str(tmp_path / "h1")])
    assert h1["scans"] == 4 and h1["chunk"] == 2 and h1["checkpoint"].endswith(".npz")
    h2 = _sweep(capsys, common + ["--resume", h1["checkpoint"], "--traj_out", str(tmp_path / "h2")])
    assert h2["resumed_at"] == 4 and h2["scans"] == full["scans"] - 4
    for r in range(2):
        tf, pf, qf = read_tum(str(tmp_path / "full" / f"sim{r}.tum"))
        t1, p1, q1 = read_tum(str(tmp_path / "h1" / f"sim{r}.tum"))
        t2, p2, q2 = read_tum(str(tmp_path / "h2" / f"sim{r}.tum"))
        np.testing.assert_array_equal(np.concatenate([t1, t2]), tf)
        np.testing.assert_array_equal(np.concatenate([p1, p2]), pf)
        np.testing.assert_array_equal(np.concatenate([q1, q2]), qf)
    with pytest.raises(ValueError):
        t_cli.main(["sweep", "--device", "cpu", "--distinct", "3", "--duration", "1.0",
                    "--config_file", small_yaml, "--resume", h1["checkpoint"]])


def test_jax_fleet_checkpoint_loads_leaf_for_leaf(tmp_path):
    """A fleet checkpoint written by the JAX CLI's ``_save_fleet_ckpt`` (a
    batched carry and perturbed params, no stepping) loads in the port."""
    import jax
    import jax.numpy as jnp

    from legkilo_tpu import cli as j_cli
    from legkilo_tpu.core import eskf as j_eskf
    from legkilo_tpu.core.filter import FilterParams as JParams
    from legkilo_tpu.parallel import sweep as j_sw
    from test_fleet_pallas import _build

    scfg_j, jcfg = _build(False)
    jcarry = j_sw.batched_carry(scfg_j, 3)
    jparams = j_sw.perturb_params(JParams(
        noise=j_eskf.make_noise_params(jcfg.eskf), ext_r=jnp.eye(3),
        ext_t=jnp.asarray([0.0, 0.0, 0.2]), g_over_acc_norm=jnp.asarray(1.0)), 3, scale=0.2)
    path = j_cli._save_fleet_ckpt(str(tmp_path / "jfleet"), jcarry, jparams, 7)
    scfg = make_static_config(small_cfg())
    like = t_sw.batched_carry(scfg, 3, "cpu")
    carry, params, n_done = t_cli._load_fleet_ckpt(path, like, t_sw.perturb_params(
        params_of(small_cfg()), 3))
    assert n_done == 7
    for got, want in zip(convert.carry_leaves(carry), jax.tree.leaves(jcarry)):
        np.testing.assert_array_equal(N(got), np.asarray(want))
    for got, want in zip(convert.params_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(N(got), np.asarray(want))


def test_sweep_bags_writes_a_trajectory_a_bag(tmp_path, capsys, small_yaml):
    """``sweep --bags DIR --pallas --pipeline deferred --traj_out OUT`` with
    ``--device cpu`` over two 1 s bags (chip_smoke's writer; seeds 5 and
    6): one replica a bag, a TUM file each with a pose a fleet step, the
    poses within the golden bound of each sim's ground truth."""
    from legkilo_torch.io.tum import associate, ate_rmse

    bags = tmp_path / "bags"
    bags.mkdir()
    datas = []
    for i, seed in enumerate((5, 6)):
        data = t_sim.simulate(t_sim.SimConfig(duration=1.0, scan_points=2500, seed=seed))
        chip_smoke.write_bag(str(bags / f"b{i}.bag"), chip_smoke.imu_bag_messages(data))
        datas.append(data)
    cfg_path = tmp_path / "bag.yaml"
    cfg_path.write_text(SMALL_YAML + "redundancy: false\n")
    rec = _sweep(capsys, ["sweep", "--device", "cpu", "--bags", str(bags), "--pallas",
                          "--pipeline", "deferred", "--config_file", str(cfg_path),
                          "--traj_out", str(tmp_path / "out")])
    assert rec["replicas"] == 2 and rec["scans"] >= 10
    assert sorted(os.listdir(tmp_path / "out")) == ["b0.bag.tum", "b1.bag.tum"]
    for i, data in enumerate(datas):
        t, p, _ = read_tum(str(tmp_path / "out" / f"b{i}.bag.tum"))
        assert len(t) == rec["scans"]
        _, gt = data.gt_in_filter_frame()
        ia, ib = associate(t, data.gt_times + chip_smoke.BAG_TIME_OFFSET_S, max_dt=0.01)
        assert len(ia) >= 5
        assert ate_rmse(p[ia], gt[ib], align=False) < 0.08


def test_sweep_refuses_cuda_without_a_card():
    """``sweep`` runs on the card unless given ``--device cpu``: without a
    card it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["sweep", "--replicas", "2", "--duration", "0.3"])


# ------------------------------------------------------------------ card --


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fleet_kernels_equal_single_launches_on_card(cuda_device):
    """Each of the six kernels at B = 4 distinct replicas (the main path's
    shapes) equals four B = 1 launches, bit for bit."""
    chip_smoke.phase_build()
    cases = chip_smoke._fleet_kernel_cases(torch, cuda_device, np.random.default_rng(3), 4)
    for name, (fargs, singles, call, fleet_of, _, _) in cases.items():
        got = call(fargs)
        want = fleet_of([call(s) for s in singles])
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        assert all(torch.equal(x, y) for x, y in zip(got, want)), name


@pytest.mark.cuda
def test_fleet_of_four_equals_single_runs_on_card(cuda_device):
    """Four distinct sims (2 s) through the fleet, per scan and chunked by
    8: each replica's trajectory is its own run_offline's, bit for bit."""
    chip_smoke.phase_fleet_equal(torch, duration=2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_fleet_launches_each_kernel_once_a_step_on_card(cuda_device, b):
    """One launch of each of the six kernels a fleet step (one match pass),
    at B = 1 and B = 8 (16 scans of the bench workload)."""
    data = chip_smoke.simulate(2.0, "fleet")
    rec = chip_smoke.fleet_broadcast_run(torch, data, b, 16, f"fleet{b}", check_ate=False,
                                         profile_chunks=1)
    assert all(rec["launches"][k] == 16 for k in chip_smoke.FUSED_KERNELS)
