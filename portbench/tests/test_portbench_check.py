"""The check on the CPU at a tiny size: the port (its plain versions here)
against the reference passes, and each fault that a fleet cell can have
makes ``correct`` come out false.

The faults are planted under the harness, in the fleet it drives, and the
rest of a run goes as on the card (the look for a card is skipped): a step
that returns its state unchanged; half of the replicas left out of the
step; an answer altered where it is produced (a pose, or a match count, as
the step returns it); a later trial that starts from the last trial's
state and map, or that keeps the first trial's jitter.  A fleet on one
card has no exchange between cards to leave out.
"""

import time

import pytest

from portbench import check, control, harness

from .conftest import tiny

CELLS = ("go1_imu.mc256", "go1_kin_points.mc128", "go1_imu.mc256_c8")


def run(root, cell, fault=None, seed=2**31 + 3):
    return harness.run_cell(root, cell, seed, 0.5, False, "cpu", time.perf_counter(),
                            overrides=tiny(cell), fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_port_against_reference_passes(root, cell):
    res = run(root, cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert all(c["value"] <= c["limit"] for c in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(check.load_limits(root, cell))
    assert res["window"]["trials"] >= 2


def unchanged(fleet):
    real = fleet.call

    def call(carry, params, dev):
        _, out = real(carry, params, dev)
        return carry, out
    fleet.call = call


def half_left_out(fleet):
    """The step runs on the first half of the replicas; the others keep
    their state and their outputs are the first half's."""
    real = fleet.call
    tm = fleet.tree_map

    def call(carry, params, dev):
        h = fleet.batch // 2
        head = lambda t: tm(lambda x: x[:h], t)
        c1, o1 = real(head(carry), head(params), head(dev))
        carry = tm(lambda new, old: fleet.torch.cat([new, old[h:]]), c1, carry)
        out = tm(lambda x: fleet.torch.cat([x, x]), o1)
        return carry, out
    fleet.call = call


def pose_altered(fleet):
    real = fleet.call

    def call(carry, params, dev):
        carry, out = real(carry, params, dev)
        return carry, out._replace(pos=out.pos + 0.01)
    fleet.call = call


def matches_altered(fleet):
    real = fleet.call

    def call(carry, params, dev):
        carry, out = real(carry, params, dev)
        return carry, out._replace(n_matched=out.n_matched * 3 // 4)
    fleet.call = call


def stale_trial(fleet):
    """A trial after the first starts from the state and map the last one
    ended with."""
    real_init, real_call = fleet.init_trial, fleet.call
    last = {}

    def init_trial(trial):
        carry, params = real_init(trial)
        return (last["carry"] if trial > 0 and "carry" in last else carry), params

    def call(carry, params, dev):
        carry, out = real_call(carry, params, dev)
        last["carry"] = carry
        return carry, out
    fleet.init_trial, fleet.call = init_trial, call


def first_jitter_kept(fleet):
    """Every trial keeps the first trial's process-noise jitter."""
    real = fleet.init_trial
    fleet.init_trial = lambda trial: real(min(trial, 0))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, pose_altered, matches_altered,
                                   stale_trial, first_jitter_kept])
def test_fault_is_not_correct(root, cell, fault):
    res = run(root, cell, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The control (the reference in float32 with TF32 products) at a tiny
    size on the CPU fails the cell's limits; the fleet passes
    (test_portbench_control.py holds both at the cells' sizes on the card)."""
    rec = control.readings(root, cell, 2**31 + 5, 0.5, "cpu", overrides=tiny(cell))
    limits = check.load_limits(root, cell)
    window = type("W", (), {"non_finite": 0})
    assert check.verdict(rec["sound"], limits, window)[0], rec["sound"]
    assert not check.verdict(rec["control"], limits, window)[0], rec["control"]
