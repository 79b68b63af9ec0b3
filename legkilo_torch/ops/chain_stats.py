"""The sequential ESKF chain over a scan's buckets: CUDA kernel + plain version.

Replaces the JAX package's Pallas chain kernel (ops/pallas/chain_stats.py:
``_kernel`` :348, driven by ``_chain_call`` :444 and ``run_chain_stats``
:504).  ``chain_call`` keeps that kernel's argument contract, flattened:

    params [40]: q_diag(30) imu_r(6) g_over_acc_norm kin_meas_noise pad(2)
    clocks [2] (last predict, last update), rot0 [3,3], lin0 [27],
    cov0 [30,30], brow [NB,3] (time, gate, nmatch), etime/egate [NB,K],
    eacc/egyr [NB,K,3], efp/efv [NB,K,12], ect [NB,K,4], s40 [NB,40,40]
    -> orot [NB,3,3], opos [NB,3], orotcov/oposcov [NB,3,3], onm [NB],
       frot [3,3], flin [27], fcov [30,30], fclocks [2]

On a CUDA tensor it launches ``csrc/chain_stats.cu``: both branches as one
warp with the covariance in registers and each bucket's statistics copied
to shared memory a bucket ahead (so ``s40`` must be 16-byte aligned); the
kinematic branch splits its 18x18 inverse over the lanes.  See the source
for the design and what bounds it.  On a CPU tensor it runs
``chain_plain``, the same recursion in eskf_fused ops (the port of the JAX
package's ``filter_deferred._chain_fused_core``).

A fleet of B replicas gives every argument and output a leading B: one
launch of B warps, a replica each (the kernel's design is per replica);
``chain_plain`` runs the bucket recursion once on [B, ...] tensors.  It
runs one replica as a fleet of one: a batched product of small matrices
rounds apart from the unbatched one on the CPU (a loop of products
against a BLAS call), and so a fleet's replica equals the replica's own
call bit for bit.
"""

from __future__ import annotations

import torch

from ..core import eskf_fused as ef
from ..core.eskf import NoiseParams, imu_innovation
from ..core.state import State
from ..utils.timing import tally
from . import _build

F32 = torch.float32


def chain_plain(params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr,
                efp, efv, ect, s40, use_kin: bool):
    """Plain PyTorch version of the chain kernel (same contract).  A fleet
    (a leading B on every argument) runs the recursion once for all its
    replicas; one replica runs it as a fleet of one, so that a fleet's
    replica r equals the call on replica r alone, bit for bit (module doc)."""
    if params.dim() == 1:
        args = (params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr, efp, efv, ect, s40)
        outs = chain_plain(*(a[None] for a in args), use_kin=use_kin)
        return tuple(x[0] for x in outs)
    lead = tuple(params.shape[:-1])
    nb, kmax = etime.shape[-2:]
    q, r6 = params[..., 0:30], params[..., 30:36]
    g_an, kin_noise = params[..., 36], params[..., 37]
    noise = NoiseParams(q_diag=q, imu_meas_r=r6, kin_meas_noise=kin_noise,
                        lidar_point_meas_ratio=None)
    st, cov = State(rot=rot0, lin=lin0), cov0
    lp, lu = clocks[..., 0], clocks[..., 1]
    outs = []
    for b in range(nb):
        for k in range(kmax):
            t, g = etime[..., b, k], egate[..., b, k]
            st, cov = ef.predict(st, cov, q, (t - lp) * g, (t - lu) * g)
            if use_kin:
                h, z, r, _ = ef.build_kin_obs(
                    st, eacc[..., b, k, :], egyr[..., b, k, :],
                    efp[..., b, k, :].reshape(lead + (4, 3)),
                    efv[..., b, k, :].reshape(lead + (4, 3)), ect[..., b, k, :] > 0.5, noise, g_an,
                )
                st, cov = ef.update_by_kin_imu(st, cov, h, z, r, gate=g)
            else:
                z6 = imu_innovation(st, eacc[..., b, k, :], egyr[..., b, k, :], g_an)
                st, cov = ef.update_by_imu(st, cov, z6, r6, gate=g)
            lp = torch.where(g > 0.5, t, lp)
            lu = torch.where(g > 0.5, t, lu)
        t, g, nm = brow[..., b, 0], brow[..., b, 1], brow[..., b, 2]
        st, cov = ef.predict(st, cov, q, (t - lp) * g, (t - lu) * g)
        lp = torch.where(g > 0.5, t, lp)
        st, cov = ef.point_update_from_stats(st, cov, s40[..., b, :, :])
        lu = torch.where((g > 0.5) & (nm > 0.5), t, lu)
        outs.append((st.rot, st.pos, cov[..., 0:3, 0:3], cov[..., 3:6, 3:6], nm))
    orot, opos, orotcov, oposcov, onm = (torch.stack(x, dim=len(lead)) for x in zip(*outs))
    return orot, opos, orotcov, oposcov, onm, st.rot, st.lin, cov, torch.stack([lp, lu], dim=-1)


def chain_call(params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr,
               efp, efv, ect, s40, use_kin: bool):
    """The chain kernel on a CUDA tensor, its plain version on a CPU one;
    for a fleet, every argument with a leading B (params [B, 40])."""
    args = (params, clocks, rot0, lin0, cov0, brow, etime, egate, eacc, egyr,
            efp, efv, ect, s40)
    if params.device.type != "cuda":
        return chain_plain(*args, use_kin=use_kin)
    lead = tuple(params.shape[:-1])
    nb, kmax = etime.shape[-2:]
    shapes = ((40,), (2,), (3, 3), (27,), (30, 30), (nb, 3), (nb, kmax), (nb, kmax),
              (nb, kmax, 3), (nb, kmax, 3), (nb, kmax, 12), (nb, kmax, 12),
              (nb, kmax, 4), (nb, 40, 40))
    for i, (a, s) in enumerate(zip(args, shapes)):
        if tuple(a.shape) != lead + s or len(lead) > 1:
            raise ValueError(f"chain_call: argument {i} has shape {tuple(a.shape)}, expected "
                             f"{lead + s}")
    dev = _build.check_tensors("chain_call", args, [F32] * len(args))
    if s40.data_ptr() % 16:
        raise ValueError("chain_call: s40 is not 16-byte aligned (the kernel copies it 16 B at a time)")
    outs = empty_chain_outputs(nb, dev, lead)
    _build.launch("chain_stats_launch", args + outs,
                  [nb, kmax, int(bool(use_kin)), lead[0] if lead else 1])
    chain_call.launches += 1
    if use_kin:
        tally("chain_kin.launches", 1)
    return outs


chain_call.launches = 0


def empty_chain_outputs(nb: int, dev, lead=()):
    """The nine outputs of a chain kernel (module doc), uninitialised, with
    the leading dims ``lead`` (a fleet's (B,))."""
    shapes = ((nb, 3, 3), (nb, 3), (nb, 3, 3), (nb, 3, 3), (nb,), (3, 3), (27,), (30, 30), (2,))
    return tuple(torch.empty(tuple(lead) + s, dtype=F32, device=dev) for s in shapes)


def pack_state_and_events(carry, packet, params, use_kin: bool):
    """A scan's chain inputs that do not depend on the match, as the chain
    kernels take them: (params [40], clocks [2], rot0, lin0, cov0) and
    (etime, egate, eacc, egyr, efp, efv, ect); a fleet's (carry, packet and
    params with a leading B) with the same leading B."""
    lead = tuple(packet.imu_time.shape[:-2])
    nb, kmax = packet.imu_time.shape[-2:]
    noise = params.noise
    dev = carry.cov.device
    pvec = torch.cat([
        noise.q_diag, noise.imu_meas_r, params.g_over_acc_norm.unsqueeze(-1),
        noise.kin_meas_noise.unsqueeze(-1), torch.zeros(lead + (2,), dtype=F32, device=dev),
    ], dim=-1)
    clocks = torch.stack([carry.last_predict_t, carry.last_update_t], dim=-1)
    if use_kin:
        efp = packet.foot_pos.reshape(lead + (nb, kmax, 12)).contiguous()
        efv = packet.foot_vel.reshape(lead + (nb, kmax, 12)).contiguous()
        ect = packet.contact.to(F32)
    else:  # the IMU branch never reads them
        efp = efv = torch.zeros(lead + (nb, kmax, 12), dtype=F32, device=dev)
        ect = torch.zeros(lead + (nb, kmax, 4), dtype=F32, device=dev)
    head = (pvec, clocks, carry.state.rot.contiguous(), carry.state.lin.contiguous(),
            carry.cov.contiguous())
    events = (packet.imu_time.contiguous(), packet.imu_mask.to(F32), packet.imu_acc.contiguous(),
              packet.imu_gyr.contiguous(), efp, efv, ect)
    return head, events


def unpack_chain_outputs(carry, outs):
    """A chain kernel's nine outputs as the chains' common return value:
    (carry with the final state, cov and clocks; per-bucket rot [NB,3,3],
    pos [NB,3], rot_cov, pos_cov [NB,3,3], nmatch [NB] int32)."""
    orot, opos, orotcov, oposcov, onm, frot, flin, fcov, fclocks = outs
    new_carry = carry._replace(
        state=State(rot=frot, lin=flin), cov=fcov,
        last_predict_t=fclocks[..., 0], last_update_t=fclocks[..., 1],
    )
    return new_carry, orot, opos, orotcov, oposcov, onm.to(torch.int32)


def run_chain_stats(carry, packet, params, s40, nmatch_b, use_kin: bool = False):
    """Pack a scan's chain inputs, run ``chain_call`` and unpack; the same
    contract as the JAX package's ``run_chain_stats``: returns (carry with
    the final state, cov and clocks; per-bucket rot [NB,3,3], pos [NB,3],
    rot_cov, pos_cov [NB,3,3], nmatch [NB] int32)."""
    head, events = pack_state_and_events(carry, packet, params, use_kin)
    brow = torch.stack(
        [packet.bucket_time, packet.bucket_mask.to(F32), nmatch_b.to(F32)], dim=-1
    )
    outs = chain_call(*head, brow.contiguous(), *events, s40.contiguous(), use_kin=use_kin)
    return unpack_chain_outputs(carry, outs)
