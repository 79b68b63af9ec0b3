"""The one-warp chain kernel's factorisation, rehearsed in plain torch on the CPU.

``csrc/chain_stats.cu`` runs both branches of the fused chain as one warp:
lane c keeps column c of the covariance P in registers
(``csrc/lk_chain_warp.cuh``).  Where that layout departs from
``chain_plain`` (eskf_fused's order), this file writes the same
factorisation in plain torch:

- predict: each column applies D to itself (Q1 = P + D P, rows 0:9), which
  finishes columns 9:30 of F P F^T = Q1 + Q1 D^T; columns 0:9 take rows
  0:9 from Q1's published rows 0:9 and rows 9:30 from row c of Q1 (the
  result is symmetric);
- IMU update: P H^T read as (H P)^T (P is symmetric), the gain formed a row
  a column, the downdate P -= K (H P) column by column;
- kinematic update: H applied to P's columns on its 18 nonzero columns
  only, S = H (H P)^T + R from the published columns of H P, the nested
  Schur inverse of S kept as its blocks (Ai = A^-1, Ai B, C Ai, and the
  inverse Si of the Schur complement) and the gain row formed from them
  without S^-1 itself: with (P H^T)[c] = [u v], w = (v - u Ai B) Si and
  K[c] = [u Ai - w C Ai, w]; the downdate P -= K (H P) 18 rows wide;
- point update: S Phi read from S^T (S is symmetric), Phi^T S Phi for rows
  0:6 only, the rows of P[:, 0:6] read down P's columns 0:6, and the gain
  as (P[:, 0:6] G) A;
- exp3: sin(t)/t and (1 - cos t)/t^2 from their Taylor series below t = 0.5.

The kernel also contracts products into FMAs and takes the determinants'
reciprocals within 2 ulp; those round differently, in no other order.

It is held against ``chain_plain`` on chip_smoke's inputs, with a gated-off
and an empty bucket (and, kin, an event without contact);
``chain_plain`` is held against the JAX package's Pallas kernel in
interpret mode in tests/test_torch_kernels.py.  The kernel itself is held
against ``chain_plain`` on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from legkilo_torch.core import eskf_fused as ef
from legkilo_torch.ops import chain_stats
from torch_util import one_thread  # noqa: F401

I3 = torch.eye(3)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "legkilo_torch", "csrc")


def exp3(w):
    """The kernel's Rodrigues exponential: Taylor series to t^8 below t = 0.5."""
    t2 = torch.sum(w * w)
    if t2 >= 0.25:
        return ef.exp3(w)
    a = 1.0 + t2 * (-1.0 / 6.0 + t2 * (1.0 / 120.0 + t2 * (-1.0 / 5040.0 + t2 * (1.0 / 362880.0))))
    b = 0.5 + t2 * (-1.0 / 24.0 + t2 * (1.0 / 720.0 + t2 * (-1.0 / 40320.0 + t2 * (1.0 / 3628800.0))))
    k = ef.skew(w)
    return I3 + a * k + b * ef.umm(k, k)


def retract(rot, lin, dx):
    """rot <- rot Exp(dx[0:3]); lin[0:n] += dx[3:3+n]."""
    n = dx.shape[0] - 3
    lin = lin.clone()
    lin[0:n] = lin[0:n] + dx[3:]
    return ef.umm(rot, exp3(dx[0:3])), lin


def predict_cols(rot, lin, P, q, dtm, dtc):
    a = exp3(-dtc * lin[18:21]) - I3
    vb = -dtc * ef.umm(rot, ef.skew(lin[15:18]))
    D = torch.zeros(9, 30)
    D[0:3, 0:3], D[0:3, 21:24] = a, dtc * I3
    D[3:6, 6:9] = dtc * I3
    D[6:9, 0:3], D[6:9, 15:18], D[6:9, 18:21] = vb, dtc * I3, dtc * rot
    q1 = P.clone()
    q1[0:9] = P[0:9] + ef.umm(D, P)               # each column: D times itself
    out = q1.clone()                              # columns 9:30 are done
    out[0:9, 0:9] = q1[0:9, 0:9] + ef.umm(q1[0:9], D.T)   # from the published rows 0:9
    out[9:30, 0:9] = q1[0:9, 9:30].T              # the result is symmetric
    out = out + torch.diag(dtc * dtc * q)
    acc_w = ef.umv(rot, lin[15:18]) + lin[12:15]
    dx = torch.cat([dtm * lin[18:21], dtm * lin[3:6], dtm * acc_w])
    return (*retract(rot, lin, dx), out)


def update_imu_cols(rot, lin, P, acc, gyr, r6, g_an, gate):
    hp = P[9:15] + P[18:24]                       # (H P)[:, c], local to column c
    pht = hp.T                                    # P H^T = (H P)^T: P is symmetric
    s = pht[9:15] + pht[18:24] + torch.diag(r6)
    k = ef.umm(pht, ef.inv6(s)) * gate
    z = torch.cat([g_an * acc - lin[15:18] - lin[6:9], gyr - lin[18:21] - lin[9:12]])
    return (*retract(rot, lin, ef.umv(k, z)), P - ef.umm(k, hp))


def h_apply(hr, hw, c, m):
    """H m for a 30-row m, in the kernel's order: rows 0:6 the IMU rows
    (ba + imu_a, bw + imu_w), foot rows h_rot m[0:3] + c m[6:9] + h_w m[21:24]
    summed term by term (H's other entries are zero)."""
    rows = [m[9:12] + m[18:21], m[12:15] + m[21:24]]
    for f in range(4):
        a = hr[f][:, 0:1] * m[0:1] + hr[f][:, 1:2] * m[1:2] + hr[f][:, 2:3] * m[2:3] + c[f] * m[6:9]
        rows.append(a + hw[f][:, 0:1] * m[21:22] + hw[f][:, 1:2] * m[22:23] + hw[f][:, 2:3] * m[23:24])
    return torch.cat(rows)


def update_kin_cols(rot, lin, P, acc, gyr, fp, fv, ct, r6, kin_noise, g_an, gate):
    hr, hw, zf, rf = [], [], [], []
    for f in range(4):                            # one lane a foot
        p, v, c = fp[3 * f:3 * f + 3], fv[3 * f:3 * f + 3], ct[f]
        wxp_v = ef.umv(ef.skew(lin[18:21]), p) + v
        hr.append(-ef.umm(rot, ef.skew(wxp_v)) * c)
        hw.append(-ef.umm(rot, ef.skew(p)) * c)
        zf.append((-lin[3:6] - ef.umv(rot, wxp_v)) * c)
        rf.append((kin_noise if c > 0.5 else torch.tensor(1.0)).expand(3))
    hp = h_apply(hr, hw, ct, P)                   # (H P)[:, c], local to column c
    pht = hp.T                                    # P H^T = (H P)^T: P is symmetric
    s = h_apply(hr, hw, ct, pht) + torch.diag(torch.cat([r6] + rf))
    ai = ef.inv9(s[0:9, 0:9])
    aib = ef.umm(ai, s[0:9, 9:18])
    cai = ef.umm(s[9:18, 0:9], ai)
    si = ef.inv9(s[9:18, 9:18] - ef.umm(s[9:18, 0:9], aib))
    u, v = pht[:, 0:9], pht[:, 9:18]              # the gain without S^-1
    w = ef.umm(v - ef.umm(u, aib), si)
    k = torch.cat([ef.umm(u, ai) - ef.umm(w, cai), w], dim=1) * gate
    z = torch.cat([g_an * acc - lin[15:18] - lin[6:9], gyr - lin[18:21] - lin[9:12]] + zf)
    return (*retract(rot, lin, ef.umv(k, z)), P - ef.umm(k, hp))


def update_stats_cols(rot, lin, P, s40):
    st = s40.T                                    # row i of S read down column i
    rf = rot.reshape(9)
    sphi = torch.zeros(40, 7)
    for j in range(3):
        sphi[:, j] = ef.umv(st[:, 9 * j:9 * j + 9], rf)
    sphi[:, 3:6] = st[:, 27:30]
    sphi[:, 6] = st[:, 39] - ef.umv(st[:, 27:30], lin[0:3]) - ef.umv(st[:, 30:39], rf)
    nq = torch.cat([ef.umm(rf[None, :], sphi[9 * i:9 * i + 9]) for i in range(3)] + [sphi[27:30]])
    return info_update_cols(rot, lin, P, nq[:, 0:6], nq[:, 6])


def info_update_cols(rot, lin, P, a, b):
    """The information update from the 6x6 normal equations (a, b), shared
    by both chain kernels."""
    g = ef.inv6(torch.eye(6) + ef.umm(a, P[0:6, 0:6]))
    u = ef.umm(P[0:6].T, g)                       # row i of P[:, 0:6] = column i's top
    k = ef.umm(u, a)
    dx = ef.umv(u, b)
    return (*retract(rot, lin, dx), P - ef.umm(k, P[0:6]))


def chain_cols(params, clocks, rot, lin, P, brow, etime, egate, eacc, egyr, efp, efv, ect, s40,
               use_kin=False):
    """The kernel's bucket walk in its own factorisation."""
    q, r6, g_an, kin_noise = params[0:30], params[30:36], params[36], params[37]
    lp, lu = clocks[0], clocks[1]
    outs = []
    for b in range(brow.shape[0]):
        for k in range(etime.shape[1]):
            t, g = etime[b, k], egate[b, k]
            rot, lin, P = predict_cols(rot, lin, P, q, (t - lp) * g, (t - lu) * g)
            if use_kin:
                rot, lin, P = update_kin_cols(rot, lin, P, eacc[b, k], egyr[b, k], efp[b, k], efv[b, k],
                                              ect[b, k], r6, kin_noise, g_an, g)
            else:
                rot, lin, P = update_imu_cols(rot, lin, P, eacc[b, k], egyr[b, k], r6, g_an, g)
            lp, lu = torch.where(g > 0.5, t, lp), torch.where(g > 0.5, t, lu)
        t, g, nm = brow[b]
        rot, lin, P = predict_cols(rot, lin, P, q, (t - lp) * g, (t - lu) * g)
        lp = torch.where(g > 0.5, t, lp)
        rot, lin, P = update_stats_cols(rot, lin, P, s40[b])
        lu = torch.where((g > 0.5) & (nm > 0.5), t, lu)
        outs.append((rot, lin[0:3], P[0:3, 0:3], P[3:6, 3:6], nm))
    orot, opos, orotcov, oposcov, onm = (torch.stack(x) for x in zip(*outs))
    return orot, opos, orotcov, oposcov, onm, rot, lin, P, torch.stack([lp, lu])


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
@pytest.mark.parametrize("nb,k", [(28, 1), (8, 2)], ids=["nb28_k1", "nb8_k2"])
def test_warp_factorisation_matches_chain_plain(nb, k, use_kin):
    args = cs.chain_holes(cs.chain_inputs(torch, "cpu", np.random.default_rng(nb + k), use_kin, nb, k))
    got = chain_cols(*args, use_kin=use_kin)
    ref = chain_stats.chain_plain(*args, use_kin=use_kin)
    assert ref[4][2 * nb // 3] == 0 and args[5][nb // 3, 1] == 0   # the empty and the gated-off bucket
    if use_kin:   # the event without contact, and events that update
        assert not args[12][nb // 2, 0].any() and args[12].sum() > 0 and args[7].sum() > 0
    # chip_smoke's tolerances: poses rel 1e-4, covariances rel 1e-3, counts and clocks exact.
    for i, (a, b) in enumerate(zip(got, ref)):
        if i in (4, 8):
            assert torch.equal(a, b), i
        else:
            assert cs.rel_err(a, b) <= (1e-3 if i in (2, 3, 7) else 1e-4), i


def test_kin_gain_without_inverse_matches_gain_from_inverse():
    """K = P H^T S^-1 from inv18 (chain_plain) and from the Schur blocks
    without S^-1 agree on one kin update from a spread covariance, and a
    gated-off update leaves the state and P unchanged bit for bit."""
    args = cs.chain_inputs(torch, "cpu", np.random.default_rng(11), True, 2, 1)
    params, rot, lin, P = args[0], args[2], args[3], args[4]
    ev = [args[8][0, 0], args[9][0, 0], args[10][0, 0], args[11][0, 0], args[12][0, 0],
          params[30:36], params[37], params[36]]
    got = update_kin_cols(rot, lin, P, *ev, torch.tensor(1.0))
    from legkilo_torch.core.state import State
    from legkilo_torch.core.eskf import NoiseParams
    noise = NoiseParams(q_diag=params[0:30], imu_meas_r=params[30:36], kin_meas_noise=params[37],
                        lidar_point_meas_ratio=None)
    st = State(rot=rot, lin=lin)
    h, z, r, _ = ef.build_kin_obs(st, ev[0], ev[1], ev[2].reshape(4, 3), ev[3].reshape(4, 3),
                                  ev[4] > 0.5, noise, params[36])
    st2, p2 = ef.update_by_kin_imu(st, P, h, z, r, gate=torch.tensor(1.0))
    assert cs.rel_err(got[0], st2.rot) <= 1e-5 and cs.rel_err(got[1], st2.lin) <= 1e-5
    assert cs.rel_err(got[2], p2) <= 1e-4
    off = update_kin_cols(rot, lin, P, *ev, torch.tensor(0.0))
    assert torch.equal(off[0], rot) and torch.equal(off[1], lin) and torch.equal(off[2], P)


def test_exp3_series_matches_exp3():
    w = torch.tensor(np.random.default_rng(1).normal(size=(64, 3)), dtype=torch.float32)
    for v in torch.cat([w * 1e-4, w * 1e-2, w * 0.15, w * 0.4]):
        assert torch.allclose(exp3(v), ef.exp3(v), rtol=0, atol=3e-7), v


def test_empty_statistics_are_an_exact_no_op():
    args = cs.chain_inputs(torch, "cpu", np.random.default_rng(3), False, 2, 1)
    rot, lin, P = args[2], args[3], args[4]
    r2, l2, p2 = update_stats_cols(rot, lin, P, torch.zeros(40, 40))
    assert torch.equal(r2, rot) and torch.equal(l2, lin) and torch.equal(p2, P)


def test_warp_kernel_takes_no_block_barrier():
    """Both branches of the fused chain are one warp a replica:
    chain_stats.cu holds no block kernel, launches a block of 32 threads a
    replica of the fleet for either branch (one block at B = 1), and orders
    its lanes with __syncwarp() only."""
    with open(os.path.join(CSRC, "chain_stats.cu")) as fh:
        src = fh.read()
    with open(os.path.join(CSRC, "lk_chain_warp.cuh")) as fh:
        hdr = fh.read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())   # comments out
    assert "__launch_bounds__(lk_warp::NW)" in src and "constexpr int NW = 32;" in hdr
    assert re.search(r"chain_warp_kernel<KIN><<<batch, lk_warp::NW,", src)
    assert "launch_warp<true>(" in src and "launch_warp<false>(" in src
    assert len(re.findall(r"__global__", code)) == 1 and "lk_chain.cuh" not in code
    assert "chain_kernel" not in code.replace("chain_warp_kernel", "")
    assert "__syncthreads" not in code and "__syncthreads" not in hdr
    assert "__syncwarp()" in code and "__syncwarp()" in hdr
    assert "atomic" not in code and "atomic" not in hdr


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_chain_call_on_cpu_is_chain_plain(use_kin):
    args = cs.chain_holes(cs.chain_inputs(torch, "cpu", np.random.default_rng(9), use_kin, 4, 1))
    n0 = chain_stats.chain_call.launches
    got = chain_stats.chain_call(*args, use_kin=use_kin)
    ref = chain_stats.chain_plain(*args, use_kin=use_kin)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert chain_stats.chain_call.launches == n0
