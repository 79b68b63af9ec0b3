"""The benchmark's inputs and what the reference derives from them, held
against the port on the CPU: the sim is the port's sim; the reference's
packets equal the port's, bit for bit; its first frame and jitter agree
with the port's to float32 rounding."""

import numpy as np
import pytest

from portbench import check, sim
from portbench.fleet import Fleet, trial_seed
from portbench.reference import inputs as rinputs
from portbench.reference.arith import Arith, tf32

from .conftest import TINY


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_sim_is_the_ports(seed):
    from legkilo_torch.models import sim as lk

    a = sim.simulate(sim.SimConfig(duration=0.5, scan_points=2000, seed=seed))
    b = lk.simulate(lk.SimConfig(duration=0.5, scan_points=2000, seed=seed))
    assert len(a.scans) == len(b.scans) == 5
    for x, y in zip(a.scans, b.scans):
        assert np.array_equal(x.points, y.points) and np.array_equal(x.time_offset, y.time_offset)
    for x, y in zip(a.kin, b.kin):
        assert x.time == y.time and np.array_equal(x.acc, y.acc)
        assert np.array_equal(x.foot_vel, y.foot_vel) and np.array_equal(x.contact, y.contact)
    assert np.array_equal(a.gt_pos, b.gt_pos) and np.array_equal(a.gt_rot, b.gt_rot)


@pytest.mark.parametrize("name", ["go1_imu", "go1_kin_points"])
def test_reference_derives_what_the_port_derives(root, name):
    from portbench import manifest

    man = manifest.Manifest(root)
    settings = man.config(name)["settings"]
    traffic = dict(man.traffic("mc128"), **{k: v for k, v in TINY.items() if k != "scan_points"})
    data = sim.simulate(sim.SimConfig(duration=2.0, scan_points=2000, seed=11))
    fleet = Fleet(settings, traffic, data, 11, "cpu")
    ref = check.Reference(settings, traffic, data)
    assert len(ref.pk) - 1 == len(fleet.calls_host)
    for a, (b,) in zip(ref.pk[1:], fleet.calls_host):
        assert np.float32(a.rebase) == np.float32(b.rebase)
        gated = [x for x in a.buckets if x.gate]
        assert len(gated) == int(b.bucket_mask.sum())
        for j, x in enumerate(gated):
            assert np.float32(x.t) == b.bucket_time[j]
            assert np.array_equal(x.points, b.points[j][b.point_mask[j]])
        evs = [e for x in a.buckets for e in x.events]
        assert len(evs) == int(b.imu_mask.sum())
        assert np.array_equal(np.float32([e.t for e in evs]), b.imu_time[b.imu_mask])
        assert np.array_equal(np.float32([e.acc for e in evs]), b.imu_acc[b.imu_mask])
    carry, params = fleet.init_trial(0)
    got = fleet.snapshot(carry, (1,))[0]
    ar = Arith()
    st = check.state_gaps(check.program_filter(got, ar), ref.start[0])
    assert st["state"] < 1e-5, st
    m = check.map_gaps(check.program_map(got, ref.cfg, ar), ref.start[1])
    assert m["slots"] < 1e-3 and m["mom"] < 1e-5 and m["flips"] == 0.0, m
    f = rinputs.jitter(fleet.batch, fleet.noise, trial_seed(11, 0))
    q0 = ref.base.q
    for r in range(fleet.batch):
        q = params.noise.q_diag[r].numpy()
        assert np.allclose(q, q0 * f[r], rtol=1e-6)
    assert abs(float(params.g_over_acc_norm[0]) - ref.base.g_an) < 1e-6


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.float32([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.14159265, 1e-30])
    y = tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == np.float32(1.0 + 2.0 ** -9)
    assert (y.view(np.uint32) & 0x1FFF == 0).all()
    assert abs(y[3] - x[3]) <= 2.0 ** -11 * 4
