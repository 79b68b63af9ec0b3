"""The per-point ESKF chain over a scan's buckets: CUDA kernel + plain version.

Replaces the JAX package's archived Pallas chain kernel
(tools/experiments/eskf_chain_pallas.py: ``_chain_kernel_grid`` :376, driven
by ``_chain_call`` :481 and ``run_chain`` :544), whose contract is that of
``filter_deferred._chain_jax``: the chain of the ``chain_impl="jax"``
deferred path, fed by per-point match rows in bucket layout instead of
per-bucket sufficient statistics.  ``chain_points_call`` keeps the kernel's
argument contract, flattened:

    params [40]: q_diag(30) imu_r(6) g_over_acc_norm kin_meas_noise pad(2)
    clocks [2] (last predict, last update), rot0 [3,3], lin0 [27],
    cov0 [30,30], btime/bgate [NB], etime/egate [NB,K], eacc/egyr [NB,K,3],
    efp/efv [NB,K,12], ect [NB,K,4], pi/n [NB,P,3] (point in the IMU frame,
    plane normal), nd [NB,P] (normal . plane centre), r [NB,P] (measurement
    variance), m [NB,P] (matched, 0/1)
    -> orot [NB,3,3], opos [NB,3], orotcov/oposcov [NB,3,3], onm [NB],
       frot [3,3], flin [27], fcov [30,30], fclocks [2]

On a CUDA tensor it launches ``csrc/chain_points.cu``: ONE warp walks the
buckets for either branch (``chain_points_warp_kernel<KIN>``, KIN =
``use_kin``) on the fused chain's device functions, each bucket's point rows
staged in shared memory a bucket ahead, each lane summing the rows lane,
lane + 32, ... and an xor butterfly adding the lanes (see the source).  P
may be any count up to ``MAX_P`` with the staging within ``STAGED_MAX``
bytes (``staged_bytes``); the wrapper refuses more before any launch.  On a
CPU tensor it runs ``chain_points_plain``, the same recursion on the
dot-product forms of core/eskf.py (the port of ``_chain_jax``'s bucket
step).  Both use the closed-form Schur inverses; the TPU kernel's body uses
Gauss-Jordan without pivoting, which differs from them by rounding only.

A fleet of B replicas gives every argument and output a leading B: one
launch of B warps, a block a replica, each walking its replica as a launch
of that replica alone does; ``chain_points_plain`` runs the recursion once
on [B, ...] tensors (one replica as a fleet of one).
"""

from __future__ import annotations

import torch

from ..core import eskf
from ..core.state import State
from . import _build
from .chain_stats import empty_chain_outputs, pack_state_and_events, unpack_chain_outputs

F32 = torch.float32
ROW_FLOATS = 9        # a point row in the kernel's ring: pi (3), n (3), nd, r, m
MAX_P = 2048          # points a bucket: the ring's two slots take 2 x 9 x P floats (147,456 B)
STAGED_MAX = 207_872  # bytes the kernel stages: 227 KB a block may opt in to, less its static buffers


def staged_bytes(nb: int, kmax: int, p: int, use_kin: bool) -> int:
    """Dynamic shared memory of the kernel: the ring of point rows and the
    event rows, nb (2 + 8 K) floats, nb (2 + 36 K) with the feet's rows."""
    return 4 * (2 * ROW_FLOATS * p + nb * (2 + (36 if use_kin else 8) * kmax))


def chain_points_plain(params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate, eacc, egyr,
                       efp, efv, ect, pi, n, nd, r, m, use_kin: bool):
    """Plain PyTorch version of the per-point chain kernel (same contract).
    A fleet (a leading B on every argument) runs the recursion once for all
    its replicas; one replica runs it as a fleet of one, so that a fleet's
    replica r equals the call on replica r alone, bit for bit (as
    ``chain_stats.chain_plain``)."""
    if params.dim() == 1:
        args = (params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate, eacc, egyr,
                efp, efv, ect, pi, n, nd, r, m)
        outs = chain_points_plain(*(a[None] for a in args), use_kin=use_kin)
        return tuple(x[0] for x in outs)
    lead = tuple(params.shape[:-1])
    nb, kmax = etime.shape[-2:]
    q, r6 = params[..., 0:30], params[..., 30:36]
    g_an, kin_noise = params[..., 36], params[..., 37]
    noise = eskf.NoiseParams(q_diag=q, imu_meas_r=r6, kin_meas_noise=kin_noise,
                             lidar_point_meas_ratio=None)
    st, cov = State(rot=rot0, lin=lin0), cov0
    lp, lu = clocks[..., 0], clocks[..., 1]
    outs = []
    for b in range(nb):
        for k in range(kmax):
            t, g = etime[..., b, k], egate[..., b, k]
            st, cov = eskf.predict(st, cov, q, (t - lp) * g, (t - lu) * g)
            if use_kin:
                h, z, rr, _ = eskf.build_kin_obs(
                    st, eacc[..., b, k, :], egyr[..., b, k, :],
                    efp[..., b, k, :].reshape(lead + (4, 3)),
                    efv[..., b, k, :].reshape(lead + (4, 3)), ect[..., b, k, :] > 0.5, noise, g_an,
                )
                st, cov = eskf.update_by_kin_imu(st, cov, h, z, rr, gate=g)
            else:
                z6 = eskf.imu_innovation(st, eacc[..., b, k, :], egyr[..., b, k, :], g_an)
                st, cov = eskf.update_by_imu(st, cov, z6, r6, gate=g)
            lp = torch.where(g > 0.5, t, lp)
            lu = torch.where(g > 0.5, t, lu)
        t, g = btime[..., b], bgate[..., b]
        st, cov = eskf.predict(st, cov, q, (t - lp) * g, (t - lu) * g)
        lp = torch.where(g > 0.5, t, lp)

        # h and z from the post-predict state (KILO.cc:190-210).
        pi_b, n_b = pi[..., b, :, :], n[..., b, :, :]
        rt_n = n_b @ st.rot                                    # R^T n
        h6 = torch.cat([torch.linalg.cross(pi_b, rt_n, dim=-1), n_b], dim=-1)
        p_w = pi_b @ st.rot.transpose(-1, -2) + st.pos[..., None, :]
        z = -(torch.sum(n_b * p_w, dim=-1) - nd[..., b, :])
        m_b = m[..., b, :] * g[..., None]
        st2, cov2 = eskf.update_by_points(st, cov, h6, z, r[..., b, :], m_b)
        nm = m_b.sum(-1)
        did = nm > 0.5
        st = State(rot=torch.where(did[..., None, None], st2.rot, st.rot),
                   lin=torch.where(did[..., None], st2.lin, st.lin))
        cov = torch.where(did[..., None, None], cov2, cov)
        lu = torch.where((g > 0.5) & did, t, lu)
        outs.append((st.rot, st.pos, cov[..., 0:3, 0:3], cov[..., 3:6, 3:6], nm))
    orot, opos, orotcov, oposcov, onm = (torch.stack(x, dim=len(lead)) for x in zip(*outs))
    return orot, opos, orotcov, oposcov, onm, st.rot, st.lin, cov, torch.stack([lp, lu], dim=-1)


def chain_points_call(params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate, eacc, egyr,
                      efp, efv, ect, pi, n, nd, r, m, use_kin: bool):
    """The per-point chain kernel on a CUDA tensor, its plain version on a
    CPU one; for a fleet, every argument with a leading B (params [B, 40]):
    one launch of B warps, a replica each."""
    args = (params, clocks, rot0, lin0, cov0, btime, bgate, etime, egate, eacc, egyr,
            efp, efv, ect, pi, n, nd, r, m)
    if params.device.type != "cuda":
        return chain_points_plain(*args, use_kin=use_kin)
    lead = tuple(params.shape[:-1])
    nb, kmax = etime.shape[-2:]
    p = pi.shape[-2]
    shapes = ((40,), (2,), (3, 3), (27,), (30, 30), (nb,), (nb,), (nb, kmax), (nb, kmax),
              (nb, kmax, 3), (nb, kmax, 3), (nb, kmax, 12), (nb, kmax, 12), (nb, kmax, 4),
              (nb, p, 3), (nb, p, 3), (nb, p), (nb, p), (nb, p))
    for i, (a, s) in enumerate(zip(args, shapes)):
        if tuple(a.shape) != lead + s or len(lead) > 1:
            raise ValueError(
                f"chain_points_call: argument {i} has shape {tuple(a.shape)}, expected {lead + s}")
    if p > MAX_P or staged_bytes(nb, kmax, p, use_kin) > STAGED_MAX:
        raise ValueError(
            f"chain_points_call: P = {p} at NB = {nb}, K = {kmax} stages "
            f"{staged_bytes(nb, kmax, p, use_kin)} B; the kernel takes P <= {MAX_P} and "
            f"<= {STAGED_MAX} B of shared memory")
    dev = _build.check_tensors("chain_points_call", args, [F32] * len(args))
    outs = empty_chain_outputs(nb, dev, lead)
    _build.launch("chain_points_launch", args + outs,
                  [nb, kmax, p, int(bool(use_kin)), lead[0] if lead else 1])
    chain_points_call.launches += 1
    return outs


chain_points_call.launches = 0


def run_chain(carry, packet, params, p_i, normal, center, r_meas, matched, use_kin: bool = False):
    """Pack a scan's chain inputs, run ``chain_points_call`` and unpack; the
    contract of ``_chain_jax`` and of the archived ``run_chain``: returns
    (carry with the final state, cov and clocks; per-bucket rot [NB,3,3],
    pos [NB,3], rot_cov, pos_cov [NB,3,3], nmatch [NB] int32); a fleet's
    (carry, packet, params and match rows with a leading B) with a leading
    B, in one launch."""
    head, events = pack_state_and_events(carry, packet, params, use_kin)
    nd = torch.sum(normal * center, dim=-1)
    outs = chain_points_call(
        *head, packet.bucket_time.contiguous(), packet.bucket_mask.to(F32).contiguous(), *events,
        p_i.contiguous(), normal.contiguous(), nd.contiguous(), r_meas.contiguous(),
        matched.to(F32), use_kin=use_kin,
    )
    return unpack_chain_outputs(carry, outs)
