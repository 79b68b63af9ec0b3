"""The cell ``go1_kin.mc128`` on the CPU at a tiny size: the shipped
kinematic deployment (leg_fusion.yaml on the fused path, NB 64, P 128, K
4, 2 ms buckets, 2^17 slots) against the reference reads ``correct``;
each planted fault of test_portbench_check.py, and two in the kinematic
events (every contact flag flipped; the kin events' feet zeroed), makes
it read not correct, so the check guards the kinematic branch; the control
reads not correct; and ``chain_kin.count`` is one launch's bytes and
operations reckoned from ``chain_warp_kernel<true>``'s loops."""

import time

import pytest

from portbench import check, control, harness
from portbench.roofline import chain_kin

from .conftest import TINY
from .test_portbench_check import (
    first_jitter_kept, half_left_out, matches_altered, pose_altered, stale_trial, unchanged,
)

CELL = "go1_kin.mc128"


def run(root, fault=None, seed=2**31 + 3):
    return harness.run_cell(root, CELL, seed, 0.5, False, "cpu", time.perf_counter(),
                            overrides=TINY, fault=fault)


def _packets_altered(fleet, alter):
    real = fleet.upload
    fleet.upload = lambda call: alter(real(call))


def contacts_flipped(fleet):
    """Every foot's contact flag of every event slot, flipped."""
    _packets_altered(fleet, lambda p: p._replace(contact=~p.contact))


def kin_zeroed(fleet):
    """The kin events' feet zeroed: positions, velocities and contacts."""
    torch = fleet.torch
    _packets_altered(fleet, lambda p: p._replace(
        foot_pos=torch.zeros_like(p.foot_pos), foot_vel=torch.zeros_like(p.foot_vel),
        contact=torch.zeros_like(p.contact)))


def test_cell_is_the_shipped_kinematic_deployment(root):
    res = run(root)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["checks"]) == set(check.load_limits(root, CELL))
    assert res["window"]["trials"] >= 2
    assert res["window"]["map_end_of_trial"]["slots_a_level"] == 1 << 17


@pytest.mark.parametrize("fault", [unchanged, half_left_out, pose_altered, matches_altered,
                                   stale_trial, first_jitter_kept, contacts_flipped, kin_zeroed])
def test_fault_is_not_correct(root, fault):
    res = run(root, fault)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(root):
    rec = control.readings(root, CELL, 2**31 + 5, 0.5, "cpu", overrides=TINY)
    limits = check.load_limits(root, CELL)
    window = type("W", (), {"non_finite": 0})
    assert check.verdict(rec["sound"], limits, window)[0], rec["sound"]
    assert not check.verdict(rec["control"], limits, window)[0], rec["control"]


def test_chain_kin_count_is_one_launch_of_the_kernel():
    """At B = 1: the bytes are the chain kernel's arguments and outputs
    (``chain_call``'s shapes, fp32) once each, 194,704 B at NB 28 / K 1
    (chip_smoke's figure); the operations are chip_smoke's ``chain_flops``
    of the kinematic branch (a predict and a kin update an event slot, a
    predict and a point update a bucket: 3.976 M at NB 28 / K 1), and both
    scale with the replicas."""
    import math

    from legkilo_torch.ops.chain_stats import empty_chain_outputs

    for nb, k in ((28, 1), (64, 4)):
        shapes = dict(B=1, nb=nb, k=k, p=128, use_kin=True)
        n_bytes, n_flops = chain_kin.count(shapes)
        args = ((40,), (2,), (3, 3), (27,), (30, 30), (nb, 3), (nb, k), (nb, k), (nb, k, 3),
                (nb, k, 3), (nb, k, 12), (nb, k, 12), (nb, k, 4), (nb, 40, 40))
        elems = sum(math.prod(s) for s in args)
        elems += sum(o.numel() for o in empty_chain_outputs(nb, "cpu"))
        assert n_bytes == 4 * elems
        assert n_flops == nb * (k * (4.5e3 + 116e3) + 4.5e3 + 17e3)
        assert chain_kin.count(dict(shapes, B=128)) == (128 * n_bytes, 128 * n_flops)
    assert chain_kin.count(dict(B=1, nb=28, k=1, p=256, use_kin=True)) == (194_704, 3_976_000.0)
