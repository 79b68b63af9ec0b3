"""The per-point chain kernel's point phase, rehearsed in plain torch on the CPU.

``csrc/chain_points.cu`` runs both branches of the per-point chain as one
warp on the fused chain's device functions (``csrc/lk_chain_warp.cuh``):
the event updates and the predicts are those rehearsed in
tests/test_torch_chain_warp.py, and only the point phase is new.  Lane l
takes the bucket's rows l, l + 32, ... in that order and sums its share of
the 6x6 normal equations (A's upper triangle, b, sum m gate) row by row;
an xor butterfly over offsets 16, 8, 4, 2, 1 adds the lanes; then, when the
bucket matched (sum m gate > 0.5), the information update the fused chain
also runs.  This file writes that order in float32 torch and holds the
walk against ``chain_points_plain`` on chip_smoke's inputs (with its empty
and its gated-off bucket) at chip_smoke's tolerances; the kernel itself is
held against ``chain_points_plain`` on the card (tests/test_torch_cuda.py,
chip_smoke.py).  The kernel also contracts products into FMAs, which round
differently, in no other order.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_chain_warp as tw
from legkilo_torch.ops import chain_points
from torch_util import one_thread  # noqa: F401

NW = 32
NACC = 28
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "legkilo_torch", "csrc")


def point_lanes(pi, n, nd, r, m, gate, rot, pos):
    """[32, 28]: lane l's sums over the rows l, l + 32, ... in that order,
    each row's terms as the kernel forms them."""
    R = rot.reshape(9)
    acc = torch.zeros(NW, NACC)
    for start in range(0, pi.shape[0], NW):
        e = torch.arange(start, min(start + NW, pi.shape[0]))
        px, py, pz = pi[e].unbind(-1)
        nx, ny, nz = n[e].unbind(-1)
        mv = m[e] * gate
        ux = nx * R[0] + ny * R[3] + nz * R[6]            # R^T n
        uy = nx * R[1] + ny * R[4] + nz * R[7]
        uz = nx * R[2] + ny * R[5] + nz * R[8]
        h = [py * uz - pz * uy, pz * ux - px * uz, px * uy - py * ux, nx, ny, nz]
        wx = R[0] * px + R[1] * py + R[2] * pz + pos[0]   # R p + t
        wy = R[3] * px + R[4] * py + R[5] * pz + pos[1]
        wz = R[6] * px + R[7] * py + R[8] * pz + pos[2]
        z = -((nx * wx + ny * wy + nz * wz) - nd[e])
        w = mv * torch.reciprocal(r[e] + 1e-4)
        hw = [hi * w for hi in h]
        terms = [hw[i] * h[j] for i in range(6) for j in range(i, 6)] + [x * z for x in hw] + [mv]
        acc[: len(e)] = acc[: len(e)] + torch.stack(terms, -1)
    return acc


def butterfly(acc):
    """The xor butterfly over the lanes (offsets 16, 8, 4, 2, 1)."""
    lanes = torch.arange(NW)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[lanes ^ off]
    return acc


def normal_eq(acc):
    """A (6x6, symmetric) and b from the summed acc."""
    iu = torch.triu_indices(6, 6)
    a = torch.zeros(6, 6)
    a[iu[0], iu[1]] = acc[0:21]
    a[iu[1], iu[0]] = acc[0:21]
    return a, acc[21:27]


def point_update_cols(rot, lin, P, pi, n, nd, r, m, gate):
    """The point phase, then the information update when the bucket matched
    (every lane reads the same sum m gate, so takes the same branch)."""
    acc = butterfly(point_lanes(pi, n, nd, r, m, gate, rot, lin[0:3]))[0]
    nm = acc[27]
    if nm > 0.5:
        rot, lin, P = tw.info_update_cols(rot, lin, P, *normal_eq(acc))
    return rot, lin, P, nm


def chain_points_cols(params, clocks, rot, lin, P, btime, bgate, etime, egate, eacc, egyr, efp, efv,
                      ect, pi, n, nd, r, m, use_kin=False):
    """The kernel's bucket walk in its own order (the contract of chain_points_plain)."""
    q, r6, g_an, kin_noise = params[0:30], params[30:36], params[36], params[37]
    lp, lu = clocks[0], clocks[1]
    outs = []
    for b in range(btime.shape[0]):
        for k in range(etime.shape[1]):
            t, g = etime[b, k], egate[b, k]
            rot, lin, P = tw.predict_cols(rot, lin, P, q, (t - lp) * g, (t - lu) * g)
            if use_kin:
                rot, lin, P = tw.update_kin_cols(rot, lin, P, eacc[b, k], egyr[b, k], efp[b, k], efv[b, k],
                                                 ect[b, k], r6, kin_noise, g_an, g)
            else:
                rot, lin, P = tw.update_imu_cols(rot, lin, P, eacc[b, k], egyr[b, k], r6, g_an, g)
            lp, lu = torch.where(g > 0.5, t, lp), torch.where(g > 0.5, t, lu)
        t, g = btime[b], bgate[b]
        rot, lin, P = tw.predict_cols(rot, lin, P, q, (t - lp) * g, (t - lu) * g)
        lp = torch.where(g > 0.5, t, lp)
        rot, lin, P, nm = point_update_cols(rot, lin, P, pi[b], n[b], nd[b], r[b], m[b], g)
        lu = torch.where((g > 0.5) & (nm > 0.5), t, lu)
        outs.append((rot, lin[0:3], P[0:3, 0:3], P[3:6, 3:6], nm))
    orot, opos, orotcov, oposcov, onm = (torch.stack(x) for x in zip(*outs))
    return orot, opos, orotcov, oposcov, onm, rot, lin, P, torch.stack([lp, lu])


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
@pytest.mark.parametrize("nb,k,p", [(28, 1, 256), (8, 2, 200)], ids=["nb28_k1_p256", "nb8_k2_p200"])
def test_points_warp_order_matches_chain_points_plain(nb, k, p, use_kin):
    args = cs.chain_points_inputs(torch, "cpu", np.random.default_rng(nb + k + p), use_kin, nb, k, p)
    got = chain_points_cols(*args, use_kin=use_kin)
    ref = chain_points.chain_points_plain(*args, use_kin=use_kin)
    assert ref[4][2 * nb // 3] == 0 and ref[4][nb // 3] == 0 and ref[4].sum() > 100   # the holes
    if use_kin:
        assert args[13].sum() > 0 and args[8].sum() > 0   # feet in contact, events that update
    # chip_smoke's tolerances: poses rel 1e-4, covariances rel 1e-3, counts and clocks exact.
    for i, (a, b) in enumerate(zip(got, ref)):
        if i in (4, 8):
            assert torch.equal(a, b), i
        else:
            assert cs.rel_err(a, b) <= (1e-3 if i in (2, 3, 7) else 1e-4), i


def test_butterfly_leaves_the_same_bits_on_every_lane():
    """Sums over 256 rows of mixed sign and magnitude: every lane ends with
    the same bits, within float32 rounding of the float64 sum."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(NW, NACC)) * 10.0 ** rng.integers(-6, 4, size=(NW, NACC)),
                     dtype=torch.float32)
    out = butterfly(x)
    assert all(torch.equal(out[lane], out[0]) for lane in range(NW))
    ref = x.double().sum(0)
    assert torch.all((out[0].double() - ref).abs() <= 1e-5 * x.double().abs().sum(0))


@pytest.mark.parametrize("hole", ["unmatched", "gated_off"])
def test_unmatched_or_gated_off_bucket_leaves_the_state_bit_equal(hole):
    """A bucket without a match (its rows zero, as _batched_match leaves
    them) or gated off sums to exactly zero on every lane: no update, and
    the state passes through bit for bit; the information update from zero
    normal equations would itself be an exact no-op."""
    args = cs.chain_points_inputs(torch, "cpu", np.random.default_rng(3), False, 3, 1, 96)
    rot, lin, P = args[2], args[3], args[4]
    pi, n, nd, r, m = (x[1] for x in args[14:19])   # bucket 1: ~70% of its rows matched
    assert m.sum() > 50
    gate = torch.tensor(1.0)
    if hole == "unmatched":
        n, nd, r, m = n * 0, nd * 0, r * 0, m * 0
    else:
        gate = torch.tensor(0.0)
    assert torch.equal(butterfly(point_lanes(pi, n, nd, r, m, gate, rot, lin[0:3])), torch.zeros(NW, NACC))
    r2, l2, p2, nm = point_update_cols(rot, lin, P, pi, n, nd, r, m, gate)
    assert nm == 0 and torch.equal(r2, rot) and torch.equal(l2, lin) and torch.equal(p2, P)
    r2, l2, p2 = tw.info_update_cols(rot, lin, P, torch.zeros(6, 6), torch.zeros(6))
    assert torch.equal(r2, rot) and torch.equal(l2, lin) and torch.equal(p2, P)


def test_chain_points_kernel_is_one_warp():
    """chain_points.cu holds one kernel, the KIN template, launched with 32
    threads a block, a block a replica, for either branch, ordered by
    __syncwarp() only, with no atomic; the block chain's header is gone and
    nothing includes it."""
    with open(os.path.join(CSRC, "chain_points.cu")) as fh:
        src = fh.read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())   # comments out
    assert len(re.findall(r"__global__", code)) == 1
    assert re.search(r"template <bool KIN>\s*__global__ void __launch_bounds__\(lk_warp::NW\)\s*"
                     r"chain_points_warp_kernel\(", code)
    assert re.search(r"chain_points_warp_kernel<KIN><<<batch, lk_warp::NW,", code)
    assert "launch_points_warp<true>(" in code and "launch_points_warp<false>(" in code
    assert "__syncthreads" not in code and "atomic" not in code and "__syncwarp()" in code
    assert '#include "lk_chain_warp.cuh"' in code
    assert not os.path.exists(os.path.join(CSRC, "lk_chain.cuh"))
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as fh:
            assert "lk_chain.cuh" not in fh.read(), name


def test_wrapper_limits_match_the_kernel():
    """The wrapper's staging rule is the kernel's: the same row width and
    byte budget, and the path's largest shapes (NB = 56, K = 3, kin, P = 256)
    and P = MAX_P at NB = 28 fit it."""
    with open(os.path.join(CSRC, "chain_points.cu")) as fh:
        src = fh.read()
    assert f"constexpr int ROW_FLOATS = {chain_points.ROW_FLOATS};" in src
    assert f"constexpr size_t STAGED_MAX = {chain_points.STAGED_MAX};" in src
    assert chain_points.staged_bytes(56, 3, 256, True) <= chain_points.STAGED_MAX
    assert chain_points.staged_bytes(28, 1, chain_points.MAX_P, True) <= chain_points.STAGED_MAX
    assert chain_points.staged_bytes(28, 1, 256, False) == 4 * (2 * 9 * 256 + 28 * 10)


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_points_call_on_cpu_is_chain_points_plain(use_kin):
    args = cs.chain_points_inputs(torch, "cpu", np.random.default_rng(9), use_kin, 4, 1, 64)
    n0 = chain_points.chain_points_call.launches
    got = chain_points.chain_points_call(*args, use_kin=use_kin)
    ref = chain_points.chain_points_plain(*args, use_kin=use_kin)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert chain_points.chain_points_call.launches == n0
