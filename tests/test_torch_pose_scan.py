"""The pose kernel's merged latch/clock scan, held on the CPU.

``csrc/pose_prop.cu`` and ``pose_prop.pose_plain`` run the rate latch (the
has-event flag and six rates, filled with 0) and the last-predict clock's
cummax (the valid slots' times, filled with -3e38) as one doubling scan of
8 words, then take max(clock, last predict) and shift all 8 words by one
slot with the last predict as the clock's fill.  The JAX kernel
(``legkilo_tpu/ops/pallas/pose_prop.py``) runs them as two scans, of 7
words and of 1.  A select and a max give the same bits in any order; this
file holds ``pose_prop._latch_clock`` bit-equal to the two-scan order on
``chip_smoke.pose_inputs``'s timelines, with and without an event-free head
and gated-out slots.  The kernel itself is held bit-equal to ``pose_plain``
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from legkilo_torch.ops import pose_prop as pp
from torch_util import one_thread  # noqa: F401


def two_scans(s, rows):
    """w_seg, a_seg and dt in the JAX kernel's order: the latch's 7-word
    scan, its shift by one, then the clock's own scan and shift."""
    t, gate, has = rows[0], rows[1] > 0.5, rows[2]
    val = [rows[3 + i] - s[pp.P_BW + i] for i in range(3)]
    val += [s[pp.P_GSC] * rows[6 + i] - s[pp.P_BA + i] for i in range(3)]
    for n in pp._steps(rows.shape[1]):
        has_sh = pp._shift(has, n, 0.0)
        val = [torch.where(has > 0.5, v, pp._shift(v, n, 0.0)) for v in val]
        has = torch.maximum(has, has_sh)
    has_p = pp._shift(has, 1, 0.0) > 0.5
    w_seg = [torch.where(has_p, pp._shift(val[i], 1, 0.0), s[pp.P_IMU_W + i]) for i in range(3)]
    a_seg = [torch.where(has_p, pp._shift(val[3 + i], 1, 0.0), s[pp.P_IMU_A + i]) for i in range(3)]
    lp = s[pp.P_LP]
    tv = torch.where(gate, t, torch.full_like(t, pp._NEG))
    for n in pp._steps(rows.shape[1]):
        tv = torch.maximum(tv, pp._shift(tv, n, pp._NEG))
    dt = torch.where(gate, t - pp._shift(torch.maximum(tv, lp), 1, lp), torch.zeros_like(t))
    return w_seg, a_seg, dt


@pytest.mark.parametrize("variant", ["as_drawn", "no_event_head", "gated_half"])
@pytest.mark.parametrize("nb,k", [(28, 1), (20, 3), (28, 5), (28, 12), (256, 4)],
                         ids=["mp128", "mp128_k3", "mp256", "mp384", "mp1280"])
def test_merged_latch_clock_scan_is_bit_equal_to_two_scans(nb, k, variant):
    """The kernel's one 8-word scan gives the two-scan order's bits at MP
    128 to 1,280: the rates wherever an event came before, the carried imu
    rates where none did (``no_event_head``: the first 40 slots hold no
    event), and dt where slots are gated out (``gated_half``: every other
    valid slot of the first half masked, so the clock skips them)."""
    par, rows = cs.pose_inputs(torch, "cpu", np.random.default_rng(nb * 100 + k), nb, k)
    mp = rows.shape[1]
    if variant == "no_event_head":
        rows[2, :40] = 0.0
    elif variant == "gated_half":
        rows[1, : mp // 2 : 2] = 0.0
    s = par.reshape(-1)
    w_m, a_m, dt_m = pp._latch_clock(s, rows)
    w_s, a_s, dt_s = two_scans(s, rows)
    for x, y in zip(w_m + a_m + [dt_m], w_s + a_s + [dt_s]):
        assert torch.equal(x, y)
    assert bool((dt_m != 0).any()) and bool((dt_m == 0).any())
    if variant == "no_event_head":   # the carried rates reach the slots up to the first event
        assert torch.equal(w_m[0][:40], torch.full((40,), float(s[pp.P_IMU_W])))
    assert bool(torch.isfinite(pp.pose_plain(par, rows)).all())
