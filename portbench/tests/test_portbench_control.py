"""The control on the card, at each cell's own size: the reference put in
the fleet's place in float32 with TF32 products comes out not correct on
every seed, and the fleet itself comes out correct (portbench/control.py)."""

import pytest

from portbench import check, control

CELLS = ("go1_imu.mc256", "go1_kin_points.mc128", "go1_imu.mc256_c8")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [9_001, 2**31 + 9_002, 9_003])
def test_control_is_not_correct(root, card, cell, seed):
    rec = control.readings(root, cell, seed, 2.0, "cuda")
    limits = check.load_limits(root, cell)
    window = type("W", (), {"non_finite": rec["non_finite"]})
    assert check.verdict(rec["sound"], limits, window)[0], rec["sound"]
    assert not check.verdict(rec["control"], limits, window)[0], rec["control"]
