"""Checkpoint save/load of the port (legkilo_torch/io/checkpoint.py, the runner's
save_checkpoint / load_checkpoint) on the CPU: resume is bit-identical to the
uninterrupted run, streaming and chunked; the file format is the JAX
package's in both directions; the escalation latch survives.
"""

import numpy as np
import pytest

import jax

from legkilo_tpu import config as j_config
from legkilo_tpu import runner as j_runner
from legkilo_tpu.io import checkpoint as j_ckpt
from legkilo_tpu.models import sim as j_sim

from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch import runner as t_runner
from legkilo_torch.io import checkpoint as t_ckpt
from legkilo_torch.models import sim as t_sim
from test_torch_slice import make_cfg
from torch_util import one_thread  # noqa: F401

N_FIRST = 6


@pytest.fixture(scope="module")
def sim_data():
    return t_sim.simulate(t_sim.SimConfig(duration=1.1, scan_points=2000, seed=5))


def _rest(data, path, n_first):
    """The scans after the first ``n_first`` and the events the checkpoint
    has not consumed (those buffered in between come back from the file)."""
    with np.load(path) as d:
        let = float(d["x_last_event_time"])
    return data.scans[n_first:], [e for e in data.imu if e.time > let]


@pytest.mark.parametrize("chunk", [0, 3], ids=["streaming", "chunk3"])
def test_resume_is_bit_identical_to_the_uninterrupted_run(sim_data, tmp_path, chunk):
    cfg = make_cfg(t_config, five=True)
    whole = t_runner.run_offline(cfg, sim_data.scans, sim_data.imu, device="cpu", chunk=chunk)
    first = t_runner.run_offline(cfg, sim_data.scans[:N_FIRST], sim_data.imu, device="cpu",
                                 chunk=chunk, save_ckpt=str(tmp_path / "ck"))
    path = str(tmp_path / "ck.npz")
    with np.load(path) as d:
        assert int(d["step"]) == len(first) == N_FIRST and int(d["x_initialized"]) == 1
    scans, events = _rest(sim_data, path, N_FIRST)
    rest = t_runner.run_offline(cfg, scans, events, device="cpu", chunk=chunk, resume=path)
    assert len(whole) >= 10 and len(first) + len(rest) == len(whole)
    for a, b in zip(first + rest, whole):
        assert a.time == b.time and a.n_matched == b.n_matched and a.n_points == b.n_points
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.rot, b.rot)
    assert rest[-1].n_matched > 100


def test_jax_checkpoint_loads_and_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the JAX runner wrote (carry and host-side extras) loads
    into the port's runner leaf for leaf, and the resumed port run tracks the
    resumed JAX run, both escalating to iterated matching on the way (1 cm:
    the bound test_run_offline_gap_reset_matches_jax holds two whole runs
    to, the packages parting by millimetres through the map); a checkpoint
    the port wrote loads with the JAX package's loader."""
    jdata = j_sim.simulate(j_sim.SimConfig(duration=0.9, scan_points=2000, seed=5))
    jcfg, tcfg = make_cfg(j_config), make_cfg(t_config)
    n = 5
    j_runner.run_offline(jcfg, jdata.scans[:n], jdata.imu, save_ckpt=str(tmp_path / "jax"))
    path = str(tmp_path / "jax.npz")
    tr = t_runner.OdometryRunner(tcfg, device="cpu")
    jr = j_runner.OdometryRunner(jcfg)
    assert tr.load_checkpoint(path) == jr.load_checkpoint(path) == n
    for a, b in zip(convert.carry_to_numpy(tr.carry), jax.tree.leaves(jr.carry)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tr.initialized and float(tr.params.g_over_acc_norm) == float(jr.params.g_over_acc_norm)
    tb, jb = tr.builder, jr.builder
    assert (tb._last_begin, tb._last_scan_time, tb._last_event_time, len(tb._events)) == (
        jb._last_begin, jb._last_scan_time, jb._last_event_time, len(jb._events))
    assert len(tb._events) > 0
    np.testing.assert_array_equal(tb._events[0].acc, jb._events[0].acc)

    with np.load(path) as d:
        let = float(d["x_last_event_time"])
    events = [e for e in jdata.imu if e.time > let]
    jres = j_runner.run_offline(jcfg, jdata.scans[n:], events, resume=path)
    tdata = t_sim.simulate(t_sim.SimConfig(duration=0.9, scan_points=2000, seed=5))
    tres = t_runner.run_offline(tcfg, tdata.scans[n:], [e for e in tdata.imu if e.time > let],
                                device="cpu", resume=path, save_ckpt=str(tmp_path / "port"))
    assert len(tres) == len(jres) >= 3
    for rt, rj in zip(tres, jres):
        assert rt.time == rj.time and rt.n_points == rj.n_points
        np.testing.assert_allclose(rt.pos, rj.pos, atol=1e-2)
        np.testing.assert_allclose(rt.rot, rj.rot, atol=1e-2)
    np.testing.assert_allclose(tres[0].pos, jres[0].pos, atol=2e-4)   # one step from the same state

    jc, step, extras = j_ckpt.load(str(tmp_path / "port.npz"), jr.carry)
    assert step == len(tres) and int(extras["initialized"]) == 1 and "esc_active" in extras
    tc, tstep, textras = t_ckpt.load(str(tmp_path / "port.npz"), tr.carry)
    assert tstep == step and set(textras) == set(extras)
    for a, b in zip(convert.carry_to_numpy(tc), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoint_preserves_escalation_state(tmp_path):
    """Escalation is sticky: a run that escalated comes back escalated, on
    the iterated-matching configuration, with its counters."""
    cfg = make_cfg(t_config, five=True)
    r = t_runner.OdometryRunner(cfg, device="cpu")
    r._esc_active, r._esc_latched, r._esc_streak, r._n_done = True, True, 2, 57
    r._scfg_active = r._scfg_esc
    path = r.save_checkpoint(str(tmp_path / "esc"))
    assert path.endswith("esc.npz")
    r2 = t_runner.OdometryRunner(cfg, device="cpu")
    assert r2._scfg_active.match_iters == 1
    assert r2.load_checkpoint(path) == 0
    assert (r2._esc_active, r2._esc_latched, r2._esc_streak, r2._n_done) == (True, True, 2, 57)
    assert r2._scfg_active.match_iters == cfg.tpu.match_iters_escalated == 3


def test_checkpoint_of_another_config_is_refused(tmp_path):
    r = t_runner.OdometryRunner(make_cfg(t_config), device="cpu")
    path = r.save_checkpoint(str(tmp_path / "small"))
    big = make_cfg(t_config)
    big.voxel_map.capacity_log2 += 1
    with pytest.raises(ValueError, match="config mismatch"):
        t_runner.OdometryRunner(big, device="cpu").load_checkpoint(path)
    kin = make_cfg(t_config, use_kin=True)
    with pytest.raises(ValueError, match="kinematic mode"):
        t_runner.OdometryRunner(kin, device="cpu").load_checkpoint(path)


def test_cli_resume_continues_a_saved_run(tmp_path, capsys):
    """``sim --save_ckpt`` then ``sim --resume --skip_scans``: the CLI's own
    way to continue, on the CPU."""
    import json

    from legkilo_torch import cli

    base = ["sim", "--device", "cpu", "--scan_points", "1500"]
    ck = str(tmp_path / "cli.npz")
    assert cli.main(base + ["--duration", "0.8", "--save_ckpt", ck]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(base + ["--duration", "1.4", "--resume", ck, "--skip_scans", str(first["scans"])]) == 0
    rest = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["scans"] >= 6 and rest["scans"] >= 5 and rest["ate_rmse_m"] < 0.08
