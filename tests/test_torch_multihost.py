"""The port's multi-device layer (``legkilo_torch/parallel/``: multihost,
mesh, scaling, the sharded fleet; the CLI's ``--coordinator`` flags and
``scale``) on the CPU, across OS processes joined by gloo.

Two ranks run as subprocesses (one intra-op thread each, a 120 s timeout,
both killed on a timeout, as tests/test_multihost.py runs the JAX
package's).  The sharded fleet step (tests/torch_multihost_worker.py: four
distinct replicas of the five-kernel configuration at
tests/test_torch_fleet.py's small size, two a rank, three steps) gives
every rank the ``FleetStats`` of a one-process fleet of four and each rank
its rows of that fleet's carry, ``torch.equal``; the fleet tracks the JAX
package's sharded ``make_fleet_step`` on conftest's virtual CPU devices at
tests/test_torch_fleet.py's tolerances.  The CLI across two ranks equals
one process: ``sweep`` in broadcast mode (its ``final_spread_m``) and with
``--distinct`` (TUM files byte for byte, checkpoint leaves, resumed
trajectories); ``scale`` gives a record a rank count.  The CLI cases run
the small configuration (tests/test_torch_fleet.py's ``SMALL_YAML``) to
keep the file within ~90 s of one worker.  The tests marked ``cuda``
repeat the two-rank equality on a card (two ranks sharing it over gloo)
and over NCCL (two cards).
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

from legkilo_torch import convert
from legkilo_torch.parallel import mesh as t_mesh
from legkilo_torch.parallel import multihost
from test_torch_fleet import SMALL_YAML
from torch_util import N, one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")
TIMEOUT_S = 120


COORDINATOR_LINE = re.compile(r"coordinator listening on [^\s:]+:(\d+)")


def _env(cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("LOCAL_RANK", None)
    env.pop("LOCAL_WORLD_SIZE", None)
    return env


def _coordinator_port(proc, err_file) -> int:
    """The port rank 0's coordinator binds (``127.0.0.1:0`` lets it take a
    free one, and ``multihost.initialize`` logs it), read from its stderr."""
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        err_file.seek(0)
        m = COORDINATOR_LINE.search(err_file.read())
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    err_file.seek(0)
    raise AssertionError(f"rank 0 logged no coordinator port:\n{err_file.read()[-3000:]}")


def run_ranks(argv_of, cwd, n=2):
    """Start rank 0 with ``argv_of(0, "127.0.0.1:0")``: its coordinator binds
    a free port of its own and logs it, so no other process can take a port
    picked for it before it listens.  Then start ``argv_of(rank,
    coordinator)`` for the other ranks on that port, wait for all (killing
    all on a timeout or a failure) and return their stdouts; a failure
    shows every rank's stderr."""
    errs = [tempfile.TemporaryFile("w+") for _ in range(n)]

    def start(i, coord):
        return subprocess.Popen(argv_of(i, coord), env=_env(cwd), cwd=cwd, stdout=subprocess.PIPE,
                                stderr=errs[i], text=True)

    procs = []
    try:
        procs.append(start(0, "127.0.0.1:0"))
        if n > 1:
            coord = f"127.0.0.1:{_coordinator_port(procs[0], errs[0])}"
            procs += [start(i, coord) for i in range(1, n)]
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        if any(p.returncode for p in procs):
            text = []
            for i, (p, e) in enumerate(zip(procs, errs)):
                e.seek(0)
                text.append(f"rank {i} (exit code {p.returncode}):\n{e.read()[-3000:]}")
            raise AssertionError("rank failed:\n" + "\n".join(text))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for e in errs:
            e.close()


def cli_ranks(args, cwd, n=2):
    """``python -m legkilo_torch ARGS`` on ``n`` ranks (``n`` = 1: one
    process without the flags); the JSON of the one rank that prints."""
    def argv(i, coord):
        extra = [] if n == 1 else ["--coordinator", coord, "--num_processes", str(n),
                                   "--process_id", str(i)]
        return [sys.executable, "-m", "legkilo_torch"] + args + extra

    lines = [l for o in run_ranks(argv, cwd, n) for l in o.splitlines() if l.startswith(("{", "["))]
    assert len(lines) == 1, lines  # rank 0 alone prints
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def two_rank_fleet(tmp_path_factory):
    """The worker's npz of each of two ranks, and the one-process fleet of
    four on the same inputs: (per-rank dicts, carry, stats)."""
    import torch_multihost_worker as w

    d = tmp_path_factory.mktemp("ranks")
    run_ranks(lambda i, coord: [sys.executable, WORKER, str(i), "2", coord, str(d / f"r{i}.npz")],
              ROOT)
    ranks = [dict(np.load(d / f"r{i}.npz")) for i in range(2)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        start = w.fleet_start()
        carry, stats = w.run_fleet(*start)
    finally:
        torch.set_num_threads(n)
    return ranks, start, carry, stats


def test_sharded_fleet_equals_one_process(two_rank_fleet):
    """Both ranks hold the one-process fleet's FleetStats, and each rank's
    carry is its rows of the one-process carry, torch.equal."""
    ranks, _, carry, stats = two_rank_fleet
    leaves = convert.carry_leaves(carry)
    assert [r["rows"].tolist() for r in ranks] == [[0, 1], [2, 3]]
    for r in ranks:
        assert str(r["backend"]) == "gloo"
        for k, v in stats._asdict().items():
            assert torch.equal(torch.from_numpy(r[f"stats_{k}"]), v), k
        rows = torch.from_numpy(r["rows"])
        for i, x in enumerate(leaves):
            assert torch.equal(torch.from_numpy(r[f"leaf_{i:03d}"]), x[rows]), f"leaf {i}"
    assert float(stats.mean_matched) > 50


def test_sharded_fleet_tracks_jax_sharded_step(two_rank_fleet):
    """The JAX package's ``make_fleet_step(scfg, mesh=make_mesh(4))`` (its
    XLA arm, replicas sharded over four virtual CPU devices) from the same
    start (the port's fleet_init carry and params carried across leaf for
    leaf) on the same packets: mean_matched at atol 3, pos at rtol/atol
    2e-3 (tests/test_torch_fleet.py's bounds)."""
    import jax
    import jax.numpy as jnp

    from legkilo_tpu.core import eskf as j_eskf
    from legkilo_tpu.core.filter import FilterParams as JParams
    from legkilo_tpu.core.filter import ScanPacket as JPacket
    from legkilo_tpu.parallel import mesh as j_mesh
    from legkilo_tpu.parallel import sweep as j_sw
    from test_fleet_pallas import _build

    ranks, (_, carry0, params, steps), _, _ = two_rank_fleet
    scfg_j, jcfg = _build(False)
    like = j_sw.perturb_params(JParams(
        noise=j_eskf.make_noise_params(jcfg.eskf), ext_r=jnp.eye(3),
        ext_t=jnp.zeros(3), g_over_acc_norm=jnp.asarray(1.0)), 4)
    jparams = jax.tree.unflatten(jax.tree.structure(like),
                                 [jnp.asarray(x) for x in convert.params_to_numpy(params)])
    jcarry = jax.tree.unflatten(jax.tree.structure(j_sw.batched_carry(scfg_j, 4)),
                                [jnp.asarray(x) for x in convert.carry_to_numpy(carry0)])
    mesh = j_mesh.make_mesh(4)
    jcarry, jparams = j_mesh.shard_batch(jcarry, mesh), j_mesh.shard_batch(jparams, mesh)
    jstep = j_sw.make_fleet_step(scfg_j, mesh=mesh)
    for pk in steps:
        jp = JPacket(*(jnp.asarray(N(x)) for x in pk))
        jcarry, _, jstats = jstep(jcarry, j_mesh.shard_batch(jp, mesh), jparams)
    lin = np.concatenate([r["leaf_001"] for r in ranks])  # state.lin, pos first
    np.testing.assert_allclose(float(ranks[0]["stats_mean_matched"]), float(jstats.mean_matched),
                               atol=3.0)
    np.testing.assert_allclose(lin[:, 0:3], np.asarray(jcarry.state.pos), rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def small_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "small.yaml"
    path.write_text(SMALL_YAML)
    return str(path)


def test_cli_broadcast_sweep_on_two_ranks(tmp_path, small_yaml):
    """``sweep --device cpu --pipeline deferred --duration 1.2 --replicas 8``
    on two ranks reports processes 2, devices 2, replicas 8 and the
    one-process run's final_spread_m exactly."""
    args = ["sweep", "--device", "cpu", "--pipeline", "deferred", "--duration", "1.2",
            "--replicas", "8", "--config_file", small_yaml]
    one = cli_ranks(args, str(tmp_path), n=1)
    two = cli_ranks(args, str(tmp_path))
    assert (one["processes"], one["devices"]) == (1, 1)
    assert (two["processes"], two["devices"], two["replicas"]) == (2, 2, 8)
    assert two["final_spread_m"] == one["final_spread_m"]
    assert np.isfinite(two["final_spread_m"])


def test_cli_distinct_sweep_on_two_ranks(tmp_path, small_yaml):
    """``sweep --distinct 2 --pallas`` with ``--traj_out`` and
    ``--save_ckpt``, chunked by 2 for 4 steps, on two ranks against one
    process: the TUM files byte for byte, the checkpoints leaf for leaf,
    mean_matched and the ATEs; then both resume their checkpoint on two
    ranks to the stream's end and write the same trajectories."""
    common = ["sweep", "--device", "cpu", "--distinct", "2", "--duration", "1.0", "--pipeline",
              "deferred", "--pallas", "--config_file", small_yaml]
    runs = {}
    for n in (1, 2):
        runs[n] = cli_ranks(common + ["--max_steps", "4", "--chunk", "2", "--traj_out", f"d{n}",
                                      "--save_ckpt", f"c{n}"], str(tmp_path), n=n)
    assert runs[2]["devices"] == 2 and runs[1]["devices"] == 1
    for key in ("replicas", "scans", "mean_matched", "ate_per_replica_m", "chunk"):
        assert runs[2][key] == runs[1][key], key
    for name in ("sim0.tum", "sim1.tum"):
        assert (tmp_path / "d1" / name).read_bytes() == (tmp_path / "d2" / name).read_bytes()
    with np.load(tmp_path / "c1.npz") as a, np.load(tmp_path / "c2.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    resumed = [cli_ranks(common + ["--resume", f"c{n}.npz", "--traj_out", f"e{n}"],
                         str(tmp_path), n=n) for n in (1, 2)]
    assert resumed[0]["resumed_at"] == resumed[1]["resumed_at"] == 4
    assert resumed[0]["scans"] == resumed[1]["scans"] > 0
    for name in ("sim0.tum", "sim1.tum"):
        assert (tmp_path / "e1" / name).read_bytes() == (tmp_path / "e2" / name).read_bytes()


def test_cli_scale_on_two_ranks(tmp_path):
    """``scale --device cpu --devices 1,2 --duration 0.6`` on two ranks:
    one record a rank count with the JAX command's keys, efficiency 1 at
    the first."""
    recs = cli_ranks(["scale", "--device", "cpu", "--devices", "1,2", "--duration", "0.6"],
                     str(tmp_path))
    assert [r["devices"] for r in recs] == [1, 2]
    assert [r["replicas"] for r in recs] == [1, 2]
    for r in recs:
        assert set(r) == {"devices", "replicas", "wall_s", "replica_scans_per_s", "efficiency"}
        assert r["replica_scans_per_s"] > 0 and r["wall_s"] > 0
    assert recs[0]["efficiency"] == 1.0


def test_initialize_without_arguments_is_a_no_op():
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0


def test_meshes_without_a_process_group():
    """One process: ``make_mesh`` and ``hierarchical_mesh`` are one-rank
    meshes with their axis names; ``shard_batch`` keeps the whole batch."""
    m = t_mesh.make_mesh(device_type="cpu")
    assert m.size() == 1 and m.mesh_dim_names == (t_mesh.REPLICA_AXIS,)
    h = multihost.hierarchical_mesh("cpu")
    assert h.size() == 1 and h.mesh_dim_names == multihost.replica_axes()
    tree = _Tree(torch.arange(6.0).reshape(3, 2), torch.tensor(1.0))
    out = t_mesh.shard_batch(tree, m)
    assert torch.equal(out[0], tree[0]) and torch.equal(out[1], tree[1])
    with pytest.raises(ValueError):
        t_mesh.make_mesh(2, "cpu")


class _Tree(NamedTuple):
    rows: torch.Tensor
    scalar: torch.Tensor


class _Mesh2:
    """A stand-in for rank 1 of a two-rank mesh (no process group)."""

    mesh_dim_names = (t_mesh.REPLICA_AXIS,)

    def size(self):
        return 2


def test_shard_batch_refuses_an_indivisible_batch(monkeypatch):
    monkeypatch.setattr(t_mesh, "mesh_index", lambda mesh: 1)
    m = _Mesh2()
    x = torch.arange(8.0).reshape(4, 2)
    out = t_mesh.shard_batch(_Tree(x, torch.tensor(3.0)), m)
    assert torch.equal(out.rows, x[2:4]) and float(out.scalar) == 3.0
    with pytest.raises(ValueError, match="divisible"):
        t_mesh.shard_batch(_Tree(torch.zeros(3, 2), torch.tensor(0.0)), m)


def test_hierarchical_mesh_on_one_host_is_one_by_two(tmp_path):
    """``hierarchical_mesh()`` across two ranks of one host is a (1, 2)
    (dcn, ici) mesh, and both ranks see backend gloo on the CPU."""
    code = ("import sys, torch; from legkilo_torch.parallel import multihost as m; "
            "m.initialize(sys.argv[2], 2, int(sys.argv[1]), device='cpu'); "
            "h = m.hierarchical_mesh('cpu'); "
            "print(tuple(h.mesh.shape), h.mesh_dim_names, torch.distributed.get_backend()); "
            "torch.distributed.destroy_process_group()")
    outs = run_ranks(lambda i, coord: [sys.executable, "-c", code, str(i), coord], str(tmp_path))
    for out in outs:
        assert out.strip() == "(1, 2) ('dcn', 'ici') gloo"


GATHER_CODE = """
import sys, torch
from legkilo_torch.parallel import mesh as M, multihost
multihost.initialize(sys.argv[2], 2, int(sys.argv[1]), device="cpu")
m = M.make_mesh(device_type="cpu")
g = torch.Generator().manual_seed(0)
full = [torch.randn(4, 3, generator=g), torch.tensor([True, False, True, True]),
        torch.arange(4, dtype=torch.int64), torch.randn(4, 5, dtype=torch.float64, generator=g),
        torch.tensor([-0.0, 1.0, -0.0, 2.0], dtype=torch.float16),
        torch.randint(0, 255, (4, 3), dtype=torch.uint8, generator=g)]
out = M.gather_rows(m, [x[M.shard_rows(m, 4)] for x in full])
bits = lambda t: t if t.dtype == torch.bool else t.view(torch.uint8)
print(all(o.dtype == x.dtype and torch.equal(bits(o), bits(x)) for o, x in zip(out, full)))
torch.distributed.destroy_process_group()
"""


def test_gather_rows_is_bit_exact_for_every_dtype(tmp_path):
    """Two ranks gather their halves of float32, bool, int64, float64,
    float16 (with -0.0) and uint8 tensors in one buffer: every rank gets
    the whole tensors back bit for bit."""
    outs = run_ranks(lambda i, coord: [sys.executable, "-c", GATHER_CODE, str(i), coord],
                     str(tmp_path))
    assert [o.strip() for o in outs] == ["True", "True"]


@pytest.mark.parametrize("device_type, ranks, cards, want", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 1, "gloo"),
])
def test_backend_rule(device_type, ranks, cards, want):
    """gloo on the CPU; NCCL when every rank of a host has a card; gloo when
    a host's ranks outnumber its cards (NCCL refuses two ranks a card)."""
    assert multihost.backend_for(device_type, ranks, cards) == want


# ------------------------------------------------------------------ card --


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_distinct(tmp_path, n_ranks):
    """``sweep --distinct 4 --pallas --pipeline deferred --duration 2
    --chunk 4`` on bench.py's configuration (the batched five-kernel route)
    with --traj_out/--save_ckpt on one process and on ``n_ranks`` ranks of
    the card(s): TUM files and checkpoints equal."""
    import chip_smoke

    cfg = str(tmp_path / "bench.yaml")
    chip_smoke.bag_config_file(cfg, use_kin=False)
    common = ["sweep", "--distinct", "4", "--duration", "2", "--pipeline", "deferred", "--pallas",
              "--chunk", "4", "--config_file", cfg]
    one = cli_ranks(common + ["--traj_out", "d1", "--save_ckpt", "c1"], str(tmp_path), n=1)
    many = cli_ranks(common + ["--traj_out", "d2", "--save_ckpt", "c2"], str(tmp_path), n=n_ranks)
    assert many["devices"] == n_ranks
    assert many["mean_matched"] == one["mean_matched"]
    assert many["ate_per_replica_m"] == one["ate_per_replica_m"]
    for r in range(4):
        name = f"sim{r}.tum"
        assert (tmp_path / "d1" / name).read_bytes() == (tmp_path / "d2" / name).read_bytes()
    with np.load(tmp_path / "c1.npz") as a, np.load(tmp_path / "c2.npz") as b:
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.cuda
def test_two_ranks_sharing_a_card_equal_one_process(cuda_device, tmp_path):
    """Two ranks on one card (gloo, by the backend rule) equal one process."""
    if torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one card visible")
    _card_distinct(tmp_path, 2)


@pytest.mark.cuda
def test_nccl_ranks_on_two_cards_equal_one_process(cuda_device, tmp_path):
    """One rank a card over NCCL (needs two cards) equals one process."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    assert multihost.backend_for("cuda", 2, torch.cuda.device_count()) == "nccl"
    _card_distinct(tmp_path, 2)
