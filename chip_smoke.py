#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (legkilo_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines:

1. The card's name and power limit (nvidia-smi), then the kernels built
   from legkilo_torch/csrc (one nvcc per source, in parallel) with the
   registers and shared memory ptxas reports.
2. Every kernel of the two paths on seeded numpy inputs at the paths'
   shapes (C = 3584 match rows, L = 3 levels, NB = 28 buckets, K = 1 event
   slot, P = 256 points a bucket, R = 4096 insert rows, B = 1024 refit
   slots, MP = 128 timeline slots; both chains with kin off and on; the
   pose kernel at MP = 384 and 1,280 too, bit-equal at every MP),
   held against its plain PyTorch version on the same inputs within the
   stated tolerance, and timed with CUDA events (kernel and plain version).
   The fused chain (the one-warp kernel, both branches) runs with a
   gated-off and an empty bucket (and, kin, an event without contact), its
   two launches must be bit-equal, and each branch's ptxas registers,
   spills (must be 0) and shared memory are printed; so does the per-point
   chain (one warp too, both branches, with its empty and its gated-off
   bucket).
   moments and fit read their rows by index, as the insert hands them
   over: moments from the chain's per-bucket outputs and the keys
   kernel's [component, point] rows (R = 4096 gated rows over 3,584
   points, 200 of them in no bucket), fit from the sentinel-extended
   tables of a short run's map (its refit rows, then the sentinel row up
   to the budget); the slots on which fit and its plain version took
   different branches are counted, both print their ptxas lines (no
   spills allowed; fit's three moms storage instantiations) and two
   launches of each must be bit-equal.  The select kernel (one launch a call) runs at NB = 28 and at
   the 2 ms bucket shape (NB = 56, "select_56"), each also with its rows'
   bucket indices shuffled and one bucket empty; two launches must be
   bit-equal, and its ptxas registers, spills (must be 0) and shared
   memory are printed.  keys (a block of four warps a 32-row tile) and the
   two pose instantiations this phase launches print their ptxas lines
   too (no spills allowed), two keys launches must be bit-equal, and an
   empty kernel from the library is timed the same way as the launch
   floor (a line of its own, not in the kernels list).
3. The main path end to end: runner.run_offline on the bench.py workload
   (24 s sim, 8000 points a scan, seed 7) on the card with all five kernel
   switches on, streaming ("main"), with every launch counter set to 0
   before and read after; every kernel must have launched and the ATE must
   stay under the golden bound of 0.08 m.  Then the same workload through
   run_offline(chunk=32), bench.py's one-pass shape ("chunk"), the same
   way, and streaming with the escalation latch off ("stream1": one match
   pass a scan, as the chunked run), so the two shapes read side by side.
4. The configuration with the chain, match and insert kernels only (pose
   and refit in plain torch), cut to 8 s ("four").
5. torch.profiler traces of 20 scans of the four- and the five-kernel
   configuration: the device's busy share of the host wall clock, launches
   a scan, device time by operator.
6. The five-kernel workload with leg kinematics (only_imu_use off), 4 s.
7. The per-point path (chain_impl="jax": match rows in bucket layout, the
   per-point chain kernel, the claiming insert; pose and refit kernels on)
   on the same 24 s workload, uncut ("points"), a profiler window of it, and
   4 s of it with leg kinematics ("points_kin").
8. Paths that the runs above do not take, on the first 8 s of the same
   workload: the map slide with the constant-velocity match pose ("slide":
   a slide threshold of 1 m that the path crosses several times, each
   slide observed), the per-point path chunked by 32 ("points_chunk"), and
   2 ms buckets chunked by 32 ("ref2ms": bench.py:350-366, NB = 56,
   P = 128, the chain kernel at NB = 56).
9. The configurations off the kernels, on the same workload: ``main``'s
   configuration streamed twice over its first 8 s ("repeat": both
   trajectories and every final map table must be equal bit for bit);
   configs/leg_fusion.yaml as ``sim --config_file`` loads it (the fused
   path with every kernel switch off, leg kinematics, NB = 64, P = 128,
   caps 4,096, three levels of 2^17 slots; 3 s, "leg_fusion"); bench.py's
   configuration with the match kernels off, the match on its torch path
   feeding the chain, moments, pose and refit kernels (8 s, "mixed"); the
   default Config(), the sequential pipeline (3 s, "seq"); and
   configs/diter.yaml, sequential with leg kinematics (3 s, "seq_kin").
   leg_fusion, seq and seq_kin launch none of the kernels; mixed exactly
   its four.  The leg_fusion and seq runs each trace 2 of their scans
   after 2 (the card's activity only; "profile_leg_fusion",
   "profile_seq"), and leave those scans out of their ms/scan.

Each run sets every launch counter to 0 before and reads it after: the
kernels of the path it drives must have launched, and the others must not.

The last two lines are a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result; so does a machine without CUDA, or a
directory holding this script without the package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

ATE_BOUND_M = 0.08
MAIN_DURATION_S = 24.0   # bench.py's workload, uncut
FOUR_DURATION_S = 8.0    # the four-kernel configuration, cut
KIN_DURATION_S = 4.0     # 40 scans of the kin branch
EXTRA_DURATION_S = 8.0   # the slide, per-point chunked and 2 ms bucket runs
REPEAT_DURATION_S = 8.0  # main's configuration twice
MIXED_DURATION_S = 8.0   # the match off its kernels
# The paths off every kernel launch ~10^5 small operations a scan (seconds
# a scan on the card), so they run the fewest scans a run takes (30).
SLOW_DURATION_S = 3.0    # leg_fusion.yaml, Config() sequential, diter.yaml
SLOW_WARM, SLOW_PROF = 2, 2  # their profiler windows: 2 scans after 2, inside the runs
SLIDE_THRESH_M = 1.0     # the sim's path moves ~5 m in 8 s
SLIDE_HALF_MAP = 20      # level-0 voxels (10 m) each side of the pose
CHUNK = 32               # bench.py:190
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 on CUDA cores, H100 SXM data sheet
REPLACES = {
    "chain_stats": "legkilo_tpu/ops/pallas/chain_stats.py:348",
    "chain_stats_kin": "legkilo_tpu/ops/pallas/chain_stats.py:348",
    "keys": "legkilo_tpu/ops/pallas/match_geom.py:74",
    "select": "legkilo_tpu/ops/pallas/match_geom.py:254",
    "select_56": "legkilo_tpu/ops/pallas/match_geom.py:254",
    "moments": "legkilo_tpu/ops/pallas/insert_rows.py:46",
    "fit": "legkilo_tpu/ops/pallas/plane_fit_rows.py:122",
    "pose": "legkilo_tpu/ops/pallas/pose_prop.py:57",
    "chain_points": "tools/experiments/eskf_chain_pallas.py:376",
    "chain_points_kin": "tools/experiments/eskf_chain_pallas.py:376",
}
SOURCES = {
    "chain_stats": "legkilo_torch/csrc/chain_stats.cu",
    "chain_stats_kin": "legkilo_torch/csrc/chain_stats.cu",
    "keys": "legkilo_torch/csrc/match_geom.cu",
    "select": "legkilo_torch/csrc/match_geom.cu",
    "select_56": "legkilo_torch/csrc/match_geom.cu",
    "moments": "legkilo_torch/csrc/insert_rows.cu",
    "fit": "legkilo_torch/csrc/plane_fit_rows.cu",
    "pose": "legkilo_torch/csrc/pose_prop.cu",
    "chain_points": "legkilo_torch/csrc/chain_points.cu",
    "chain_points_kin": "legkilo_torch/csrc/chain_points.cu",
}
# The wrappers whose kernels each path launches (counter names of wrappers()).
FUSED_KERNELS = {"chain_stats", "keys", "select", "moments", "fit", "pose"}
FOUR_KERNELS = FUSED_KERNELS - {"fit", "pose"}
MIXED_KERNELS = FUSED_KERNELS - {"keys", "select"}
POINTS_KERNELS = {"chain_points", "fit", "pose"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_call(torch, fn, iters: int) -> float:
    """Mean ms of fn() over ``iters`` calls, by CUDA events, after a warm-up.
    The stream is first given ~20 ms of spin so the launches queue behind it
    and the events time the device's work rather than the host's enqueue,
    as far as the spin covers it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_floor_ms(torch) -> float:
    """Device ms a launch of the library's empty kernel (one warp, no
    work), by ``time_call``: the floor under every kernel time."""
    from legkilo_torch.ops import _build

    fn = _build._function("lk_empty_launch", 0, 0)

    def go():
        rc = fn(torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lk_empty_launch: CUDA error {rc}")

    return time_call(torch, go, 200)


def nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def bound(n_bytes: int, n_flops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bucket_targets(torch, bidx, nb):
    """Each row's bucket as the plain version reads bidx (its int64 cast),
    with ``nb`` for a row in no bucket."""
    b = bidx.long()
    return torch.where((b >= 0) & (b < nb), b, torch.full_like(b, nb))


def select_sums_vs_plain(torch, out, s40, nm, r_out, r_s40, r_nm, bidx, nb):
    """The select kernel's per-bucket s40 and match counts against the plain
    version's, with the terms of the rows whose gate flipped (matched on one
    side only) taken out of each side's sums in float64.  Returns (rel err
    of s40, whether the counts agree)."""
    flip = out[0] != r_out[0]
    tgt = bucket_targets(torch, bidx[0][flip], nb)

    def flipped_terms(o):
        x = o[6:46, flip].double()
        s = torch.zeros(nb + 1, 40, 40, dtype=torch.float64, device=o.device).index_add_(
            0, tgt, (x * o[1, flip].double()).T[:, :, None] * x.T[:, None, :])
        n = torch.zeros(nb + 1, dtype=torch.float64, device=o.device).index_add_(
            0, tgt, o[0, flip].double())
        return s[:nb].reshape(nb * 40, 40), n[:nb, None]

    ks, kn = flipped_terms(out)
    ps, pn = flipped_terms(r_out)
    e_s40 = rel_err(s40.double() - ks, r_s40.double() - ps)
    return e_s40, torch.equal(nm.double() - kn, r_nm.double() - pn)


SELECT_TOL = ("matched on >= 99.9% rows; rel 1e-4 rows; sums rel 1e-5 vs float64 of its rows "
              "and rel 1e-4 vs plain (flipped rows' terms out), counts exact; repeat bit-equal")


def select_check(torch, sargs, levels, nb, min_same=0.999):
    """select_call against select_plain on ``sargs`` (SELECT_TOL): a gate
    (rsqrt/exp/sqrt differ in the last ulp) may flip only on a knife edge,
    so matched may differ on at most 1 - ``min_same`` of the rows and the
    rest are compared at rel 1e-4; s40 and the counts are held against
    float64 sums of the kernel's own rows (order of summation only) and
    against the plain version's with the flipped rows' terms taken out of
    both; a second launch on the same inputs must be bit-equal.  Returns
    (kernel outputs, plain outputs, {flips, e_rows, e_sum, e_s40})."""
    from legkilo_torch.ops import match_geom as mg

    got = mg.select_call(*sargs, levels, nb)
    again = mg.select_call(*sargs, levels, nb)
    torch.cuda.synchronize()
    ref = mg.select_plain(*sargs, levels, nb)
    out, s40, nm = got
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"select at NB = {nb}: two launches on the same inputs differ")
    same = out[0] == ref[0][0]
    if float(same.float().mean()) < min_same:
        raise RuntimeError(f"select at NB = {nb}: matched differs on {int((~same).sum())} rows")
    e_rows = rel_err(out[:, same], ref[0][:, same])
    x = out[6:46].double()
    tgt = bucket_targets(torch, sargs[7][0], nb)
    s64 = torch.zeros(nb + 1, 40, 40, dtype=torch.float64, device=out.device).index_add_(
        0, tgt, (x * out[1].double()).T[:, :, None] * x.T[:, None, :])[:nb].reshape(nb * 40, 40)
    e_sum = rel_err(s40, s64)
    nm64 = torch.zeros(nb + 1, dtype=torch.float64, device=out.device).index_add_(
        0, tgt, out[0].double())[:nb]
    if not (e_rows <= 1e-4 and e_sum <= 1e-5 and torch.equal(nm.double(), nm64[:, None].expand(nb, 128))):
        raise RuntimeError(f"select at NB = {nb}: rel errs rows {e_rows:.3g} sums {e_sum:.3g}")
    e_s40, nm_same = select_sums_vs_plain(torch, out, s40, nm, *ref, sargs[7], nb)
    if not (e_s40 <= 1e-4 and nm_same):
        raise RuntimeError(f"select at NB = {nb}: vs plain: s40 rel err {e_s40:.3g}, counts equal {nm_same}")
    return got, ref, dict(flips=int((~same).sum()), e_rows=e_rows, e_sum=e_sum, e_s40=e_s40)


def shuffled_bidx(torch, sargs, rng, empty=None):
    """``sargs`` with the rows' bucket indices permuted at random (every
    bucket's rows scattered over the whole range, padding rows among them)
    and, with ``empty``, that bucket's rows moved to bucket 0."""
    out = list(sargs)
    c = sargs[7].shape[1]
    bidx = sargs[7][:, torch.as_tensor(rng.permutation(c), device=sargs[7].device)].contiguous()
    if empty is not None:
        bidx[bidx == float(empty)] = 0.0
    out[7] = bidx
    return out


# ----------------------------------------------------------------- inputs --


def rotations(rng, n, scale=0.3):
    from legkilo_torch.core.so3 import exp_so3
    import torch

    w = torch.tensor(rng.normal(scale=scale, size=(n, 3)), dtype=torch.float32)
    return exp_so3(w).numpy()


def chain_inputs(torch, dev, rng, use_kin, nb=28, k=1):
    from legkilo_torch.config import EskfConfig
    from legkilo_torch.core import eskf_fused as ef
    from legkilo_torch.core.eskf import make_noise_params

    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    nz = make_noise_params(EskfConfig(), "cpu")
    params = np.concatenate([nz.q_diag.numpy(), nz.imu_meas_r.numpy(), [1.0, 0.1, 0.0, 0.0]])
    a = rng.normal(size=(30, 30)) * 0.01
    cov0 = a @ a.T + 1e-4 * np.eye(30)
    lin0 = rng.normal(scale=0.05, size=27)
    lin0[12:15] = [0.0, 0.0, -9.81]
    lin0[15:18] = [0.0, 0.0, 9.81]
    bt = (np.arange(nb) + 1) * 0.004
    brow = np.stack([bt, np.ones(nb), rng.integers(0, 120, size=nb)], 1)
    etime = np.clip(bt[:, None] - 0.002, 0, None) * np.ones((1, k))
    egate = (rng.random((nb, k)) < 0.3).astype(np.float32)
    eacc = rng.normal(scale=0.05, size=(nb, k, 3))
    eacc[..., 2] += 9.81
    egyr = rng.normal(scale=0.02, size=(nb, k, 3))
    fp = rng.normal(scale=0.2, size=(nb, k, 4, 3))
    fp[..., 2] -= 0.3
    efp = fp.reshape(nb, k, 12)
    efv = rng.normal(scale=0.1, size=(nb, k, 12))
    ect = (rng.random((nb, k, 4)) < 0.6).astype(np.float32)
    if not use_kin:
        efp, efv, ect = np.zeros_like(efp), np.zeros_like(efv), np.zeros_like(ect)
    # s40 from ~120 matched floor/wall points a bucket, as the select kernel forms it.
    c = 120 * nb
    p_i = torch.tensor(rng.uniform(-5, 5, size=(c, 3)), dtype=torch.float32)
    n = torch.tensor(rng.normal(size=(c, 3)), dtype=torch.float32)
    n = n / n.norm(dim=1, keepdim=True)
    ctr = torch.tensor(rng.uniform(-5, 5, size=(c, 3)), dtype=torch.float32)
    r = torch.tensor(rng.uniform(0.01, 0.3, size=c), dtype=torch.float32)
    s40 = ef.point_suffstats_compact(p_i, n, ctr, r, torch.ones(c, dtype=torch.bool),
                                     torch.arange(c) // 120, nb)
    return [f(params), f([0.0, 0.0]), f(rotations(rng, 1, 0.1)[0]), f(lin0), f(cov0), f(brow),
            f(etime), f(egate), f(eacc), f(egyr), f(efp), f(efv), f(ect), s40.to(dev)]


def chain_holes(args):
    """Bucket nb // 3 of ``chain_inputs`` gated off, bucket 2 nb // 3
    empty (no match: its statistics and count zero) and every foot of event
    slot (nb // 2, 0) out of contact (the kin branch's inputs; the IMU
    branch's contacts are zero), in place and without a draw; at NB < 3
    these are all bucket 0."""
    nb = args[5].shape[0]
    args[5][nb // 3, 1] = 0.0
    args[5][2 * nb // 3, 2] = 0.0
    args[13][2 * nb // 3] = 0.0
    args[12][nb // 2, 0] = 0.0
    return args


def chain_points_inputs(torch, dev, rng, use_kin, nb=28, k=1, p=256):
    """The per-point chain's inputs: the state, clocks and events of
    ``chain_inputs``, and per bucket P match rows as ``_batched_match``
    leaves them: points within 5 m, unit normals, plane centres a few cm
    off the point's world position, ~70% matched, unmatched rows zero; one
    bucket without a match and one gated off."""
    base = chain_inputs(torch, dev, rng, use_kin, nb, k)
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    brow = base[5].cpu().numpy()
    bgate = brow[:, 1].copy()
    bgate[nb // 3] = 0.0
    rot0, pos0 = base[2].cpu().numpy(), base[3].cpu().numpy()[0:3]
    pi = rng.uniform(-5, 5, size=(nb, p, 3))
    n = rng.normal(size=(nb, p, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ctr = pi @ rot0.T + pos0 + rng.normal(scale=0.03, size=(nb, p, 3))
    r = rng.uniform(1e-3, 5e-2, size=(nb, p))
    m = (rng.random((nb, p)) < 0.7).astype(np.float32)
    m[2 * nb // 3] = 0.0
    n, ctr, r = n * m[..., None], ctr * m[..., None], r * m
    nd = np.sum(n.astype(np.float32) * ctr.astype(np.float32), axis=-1)
    return base[0:5] + [f(brow[:, 0]), f(bgate)] + base[6:13] + [f(pi), f(n), f(nd), f(r), f(m)]


def chain_flops(nb, k, use_kin) -> float:
    """Reckoned from the kernel's loops: a predict ~4.5k flops (the two
    passes over rows/columns 0:9 of P), the IMU update ~14k (K P, the 30x30
    downdate), the kin update ~116k (H P H^T, the nested-Schur 18x18
    inverse, the 30x18 gain, the 30x30 downdate), the point update ~17k."""
    ev = 4.5e3 + (116e3 if use_kin else 14e3)
    return nb * (k * ev + 4.5e3 + 17e3)


def chain_points_flops(nb, k, p, use_kin) -> float:
    """As ``chain_flops``, plus ~110 flops a point for its row of the normal
    equations (R^T n, the cross product, the residual, the weight, 21 + 6
    products and sums)."""
    return chain_flops(nb, k, use_kin) + nb * p * 110.0


def keys_inputs(torch, dev, rng, c=3584, levels=3):
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    par = np.zeros(64)
    par[0:9] = rotations(rng, 1, 0.05)[0].reshape(9)
    par[9:12] = [0.0, 0.0, 0.2]
    par[12:12 + levels] = [0.5 / 2 ** l for l in range(levels)]
    a = rng.normal(size=(3, 3)) * 1e-3
    par[16:25] = (a @ a.T).reshape(9)
    b = rng.normal(size=(3, 3)) * 1e-3
    par[25:34] = (b @ b.T).reshape(9)
    par[34:36] = [0.04, 0.2]
    pts = rng.uniform(-12, 12, size=(3, c))
    rb = rotations(rng, c, 0.3).reshape(c, 9).T
    pb = rng.normal(scale=2.0, size=(3, c))
    return f(par), f(pts), f(rb), f(pb)


def select_inputs(torch, dev, rng, keys_out, nb=28, levels=3):
    """Gathered plane rows around each point's candidate centres: unit
    normals, radius 0.3, a PSD 6x6 plane covariance; found/is_plane flags at
    random; rows in bucket order with padding (bidx = nb) at the end."""
    piw, covs, keys, vc, idx0 = keys_out
    c = piw.shape[1]
    nc = 2 * levels
    plane = np.zeros((nc, 31, c))
    pw = piw[3:6].cpu().numpy()
    vcs = vc.cpu().numpy().reshape(nc, 3, c)
    for m in range(nc):
        nrm = rng.normal(size=(3, c))
        nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
        plane[m, 0:3] = pw - vcs[m] + rng.normal(scale=0.05, size=(3, c))
        plane[m, 3:6] = nrm
        plane[m, 6:9] = [[1e-4], [0.01], [0.02]]
        plane[m, 9] = 0.3
        g = rng.normal(size=(c, 6, 6)) * 1e-3
        pv = g @ np.swapaxes(g, 1, 2)
        iu = np.triu_indices(6)
        plane[m, 10:31] = pv[:, iu[0], iu[1]].T
    flags = np.concatenate([rng.random((nc, c)) < 0.8, rng.random((nc, c)) < 0.7]).astype(np.float32)
    n_valid = c - 200
    mask = (np.arange(c) < n_valid).astype(np.float32)[None]
    bidx = np.minimum(np.arange(c) * nb // n_valid, nb).astype(np.float32)[None]
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    par = f([3.0, 3.0, 10.0, 0, 0, 0, 0, 0])
    return [par, piw, covs[0:18].contiguous(), vc, f(plane.reshape(nc * 31, c)), f(flags), f(mask), f(bidx)]


def moments_inputs(torch, dev, rng, r=4096, nb=28, n=3584, levels=3):
    """moments_rows_call's inputs as the insert phase hands them over: the
    chain's per-bucket outputs, the match phase's point rows in the keys
    kernel's [component, point] layout (n points in bucket order, the last
    200 in no bucket: bidx = nb), and R gated rows as gated_insert_rows
    leaves them (every valid point at level 0, then the first ones again at
    levels 1, 2, ...; lvl a column of an [R, 7] table; keys of the rows'
    own voxels)."""
    from legkilo_torch.ops import insert_rows as ir

    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    ext_r = rotations(rng, 1, 0.05)[0]
    rots = rotations(rng, nb, 0.3)
    poss = rng.normal(scale=2.0, size=(nb, 3))
    covs = [rng.normal(size=(nb, 3, 3)) * 1e-3 for _ in range(2)]
    rot_covs, pos_covs = (c @ np.swapaxes(c, 1, 2) for c in covs)
    n_valid = n - 200
    bidx = np.minimum(np.arange(n) * nb // n_valid, nb)
    p_i = rng.uniform(-10, 10, size=(n, 3))
    a = rng.normal(size=(n, 3, 3)) * 0.01
    body_cov = a @ np.swapaxes(a, 1, 2)
    lvl = np.minimum(np.arange(r) // n_valid, levels - 1)
    pidx = np.arange(r) % n_valid
    b = np.minimum(bidx, nb - 1)[pidx]
    pw = np.einsum("rij,rj->ri", rots[b], p_i[pidx]) + poss[b]
    sizes = ir.level_sizes(0.5, levels, dev)
    keys = np.floor(pw / sizes.cpu().numpy()[lvl][:, None])
    piw_t = f(np.concatenate([p_i.T, np.zeros((3, n))]))          # the keys kernel's [6, C]
    covs_t = f(np.concatenate([np.zeros((18, n)), body_cov.reshape(n, 9).T]))   # its [27, C]
    rows7 = torch.zeros((r, 7), dtype=torch.int64, device=dev)
    rows7[:, 3] = torch.as_tensor(lvl, device=dev)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
    return (f(ext_r), sizes, f(rots), f(poss), f(rot_covs), f(pos_covs), piw_t[0:3].T,
            covs_t[18:27].T.reshape(n, 3, 3), i64(pidx), i64(bidx),
            torch.as_tensor(keys.astype(np.int32), device=dev), rows7[:, 3])


def moments_bytes(margs) -> int:
    """What moments_rows_call must move for these inputs: each input once,
    the point rows (p_i, its covariance, its bucket) of the points the rows
    name, and the two outputs."""
    pidx = margs[8]
    u = int(pidx.unique().numel())
    r, nb = pidx.shape[0], margs[2].shape[0]
    return (4 * (9 + margs[1].numel() + 30 * nb) + u * (4 * 12 + 8)
            + r * (8 + 12 + 8) + r * 69 * 4)


def fit_inputs(torch, dev, budget=1024, n_scans=30):
    """fit_slots_call's inputs as the insert hands them over: the
    sentinel-extended tables of the map a short five-kernel run left, and
    refit rows naming the voxels with more points than the refit threshold
    (at most 5/8 of the budget, about the share a steady-state scan refits),
    then the sentinel row up to the budget, as the unfilled refit slots
    are."""
    from legkilo_torch.core import voxel_map as vmap
    from legkilo_torch.models import sim
    from legkilo_torch.ops import plane_fit_rows as pfr
    from legkilo_torch.runner import OdometryRunner, bench_config, replay

    data = sim.simulate(sim.SimConfig(duration=(n_scans + 1) * 0.1, scan_points=8000, seed=7))
    runner = OdometryRunner(bench_config(), device=dev)
    for _ in replay(runner, data.scans, data.imu):
        pass
    vm = runner.carry.vm
    idx = torch.nonzero(vm.meta[:, 0] > 5.0)[:, 0][: budget * 5 // 8]
    fs = torch.full((budget,), vm.meta.shape[0], dtype=torch.int64, device=dev)
    fs[: len(idx)] = idx
    tables = [vmap._with_sentinel(t) for t in (vm.meta, vm.mom, vm.moms)]
    par = pfr.fit_par(runner.scfg.map_cfg.planer_threshold, dev)
    return (par, *tables, fs), int(len(idx))


def fit_bytes(fargs) -> int:
    """What fit_slots_call must move: par, fs, the n, m1/m2 and moms row (in
    the storage dtype) of each distinct row that fs names once, and the
    [B, 35] output."""
    fs = fargs[4]
    b, u = fs.shape[0], int(fs.unique().numel())
    return 32 + 8 * b + u * (4 + 36 + 60 * fargs[3].element_size()) + 35 * 4 * b


FIT_FLOPS_PER_SLOT = 1600.0  # t 378, w 306, c 68, u 210, t_nn/t_nq 234, eigen ~320, rest ~80


def pose_inputs(torch, dev, rng, nb, k):
    """A scan's event/bucket timeline as the deferred path lays it out: K
    event slots then the bucket time, per bucket; ~40% of the event slots
    and ~90% of the buckets valid; MP = NB (K+1) padded to 128."""
    m = nb * (k + 1)
    mp = (m + 127) // 128 * 128
    bt = (np.arange(nb) + 1) * 0.004
    et = bt[:, None] - 0.004 + 0.004 * (np.arange(k)[None, :] + 0.5) / k
    ev = rng.random((nb, k)) < 0.4
    rows = np.zeros((9, mp), np.float32)
    rows[0, :m] = np.concatenate([et, bt[:, None]], 1).reshape(m)
    rows[1, :m] = np.concatenate([ev, rng.random((nb, 1)) < 0.9], 1).reshape(m)
    rows[2, :m] = np.concatenate([ev, np.zeros((nb, 1), bool)], 1).reshape(m)
    gyr = rng.normal(scale=0.5, size=(nb, k + 1, 3))
    acc = rng.normal(scale=0.5, size=(nb, k + 1, 3)) + [0.0, 0.0, 9.81]
    gyr[:, k], acc[:, k] = 0.0, 0.0
    rows[3:6, :m] = gyr.reshape(m, 3).T
    rows[6:9, :m] = acc.reshape(m, 3).T
    par = np.concatenate([
        rotations(rng, 1, 0.3)[0].reshape(9), rng.normal(size=3), rng.normal(scale=0.5, size=3),
        rng.normal(scale=0.01, size=6), [0.0, 0.0, -9.81], rng.normal(scale=0.3, size=3),
        [0.1, -0.2, 9.7], [-0.001, 1.002]])
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    return f(par), f(rows)


def pose_flops(mp) -> float:
    """Per slot: Rodrigues ~60, rot0 @ prefix 45, dv 21, the rest ~10, and per
    doubling step the 3x3 product (45), the two 3-vector sums (6) and the
    clock's max (1)."""
    steps = int(np.ceil(np.log2(mp)))
    return mp * (136.0 + steps * 52.0)


# ----------------------------------------------------------------- phases --


def phase_build():
    from legkilo_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    with open(_build.ptxas_log_path()) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("==") or "Used" in line or "Compiling entry" in line or "spill" in line:
                log(f"[ptxas] {line}")


def ptxas_entry(fragment: str) -> dict:
    """Registers, static shared bytes, stack frame and spill bytes that the
    build's ptxas log (-Xptxas -v) reports for the kernel whose mangled name
    holds ``fragment``."""
    import re

    from legkilo_torch.ops import _build

    with open(_build.ptxas_log_path()) as fh:
        lines = fh.read().splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            block = []
            for nxt in lines[n + 1:]:
                if "Compiling entry function" in nxt or nxt.startswith("=="):
                    break
                block.append(nxt)
            body = "\n".join(block)

            def total(pat):
                return sum(int(x) for x in re.findall(pat, body))

            return dict(registers=total(r"Used (\d+) registers"), smem=total(r"(\d+) bytes smem"),
                        stack=total(r"(\d+) bytes stack frame"),
                        spills=total(r"(\d+) bytes spill stores") + total(r"(\d+) bytes spill loads"))
    raise RuntimeError(f"the ptxas log has no kernel named like {fragment!r}")


def phase_kernels(torch, dev):
    """Each kernel against its plain version; returns {name: record}."""
    from legkilo_torch.ops import chain_points as cp
    from legkilo_torch.ops import chain_stats as cs
    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.ops import match_geom as mg
    from legkilo_torch.ops import plane_fit_rows as pfr
    from legkilo_torch.ops import pose_prop as pp

    rng = np.random.default_rng(7)
    recs = {}

    for name, use_kin in (("chain_stats", False), ("chain_stats_kin", True)):
        args = chain_holes(chain_inputs(torch, dev, rng, use_kin))
        got = cs.chain_call(*args, use_kin=use_kin)
        torch.cuda.synchronize()
        ref = cs.chain_plain(*args, use_kin=use_kin)
        # Poses: rel 1e-4 of their magnitude; covariances: rel 1e-3 (the
        # plain version applies F P F^T as columns-then-rows, the kernel as
        # Q1 + Q1 D^T, reads P H^T as (H P)^T, forms the kin gain from the
        # Schur blocks, and the 18x18 inverse amplifies rounding); match
        # counts and clocks exact.
        tol = [1e-4, 1e-4, 1e-3, 1e-3, 0.0, 1e-4, 1e-4, 1e-3, 0.0]
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        for i, (e, t) in enumerate(zip(errs, tol)):
            if not e <= t:
                raise RuntimeError(f"{name}: output {i} rel err {e:.3g} > {t}")
        nb, k = args[6].shape
        again = cs.chain_call(*args, use_kin=use_kin)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name}: two launches on the same inputs differ")
        tol_text = "rel 1e-4 poses, 1e-3 covariances; counts and clocks exact; repeat bit-equal"
        # The kernel template's instantiation for the branch (mangled name).
        px = ptxas_entry(f"chain_warp_kernelILb{int(use_kin)}E")
        staged = nb * (3 + (36 if use_kin else 8) * k) * 4
        log(f"[kernel] {name}: one warp, {px['registers']} registers, {px['spills']} B of spills, "
            f"{px['stack']} B stack frame, {px['smem']} B static + {staged} B staged "
            f"shared memory; bucket {nb // 3} gated off, bucket {2 * nb // 3} empty (count "
            f"{int(got[4][2 * nb // 3])}); two launches bit-equal")
        if px["spills"]:
            raise RuntimeError(f"{name}: ptxas spills {px['spills']} B in the warp kernel")
        recs[name] = dict(
            max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
            ms=time_call(torch, lambda: cs.chain_call(*args, use_kin=use_kin), 50),
            plain_ms=time_call(torch, lambda: cs.chain_plain(*args, use_kin=use_kin), 3),
            bytes=nbytes(list(args) + list(got)), flops=chain_flops(nb, k, use_kin),
            tol=tol_text,
        )
        log(f"[kernel] {name}: rel errs {[f'{e:.2e}' for e in errs]}")

    for name, use_kin in (("chain_points", False), ("chain_points_kin", True)):
        args = chain_points_inputs(torch, dev, rng, use_kin)
        got = cp.chain_points_call(*args, use_kin=use_kin)
        torch.cuda.synchronize()
        ref = cp.chain_points_plain(*args, use_kin=use_kin)
        if not all(bool(torch.isfinite(x).all()) for x in got):
            raise RuntimeError(f"{name}: non-finite output")
        # As the other chain: poses rel 1e-4, covariances rel 1e-3 (the plain
        # version forms F P F^T and the normal equations with matrix
        # products, the kernel as Q1 + Q1 D^T and a lane's rows at a stride
        # of 32 added across the warp by a butterfly); match counts and
        # clocks exact.
        tol = [1e-4, 1e-4, 1e-3, 1e-3, 0.0, 1e-4, 1e-4, 1e-3, 0.0]
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        for i, (e, t) in enumerate(zip(errs, tol)):
            if not e <= t:
                raise RuntimeError(f"{name}: output {i} rel err {e:.3g} > {t}")
        again = cp.chain_points_call(*args, use_kin=use_kin)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name}: two launches on the same inputs differ")
        nb, k = args[7].shape
        p = args[14].shape[1]
        px = ptxas_entry(f"chain_points_warp_kernelILb{int(use_kin)}E")
        log(f"[kernel] {name}: one warp, {px['registers']} registers, {px['spills']} B of spills, "
            f"{px['stack']} B stack frame, {px['smem']} B static + "
            f"{cp.staged_bytes(nb, k, p, use_kin)} B staged shared memory (the ring of point rows "
            f"and the event rows); two launches bit-equal")
        if px["spills"]:
            raise RuntimeError(f"{name}: ptxas spills {px['spills']} B in the warp kernel")
        recs[name] = dict(
            max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
            ms=time_call(torch, lambda: cp.chain_points_call(*args, use_kin=use_kin), 50),
            plain_ms=time_call(torch, lambda: cp.chain_points_plain(*args, use_kin=use_kin), 3),
            bytes=nbytes(list(args) + list(got)), flops=chain_points_flops(nb, k, p, use_kin),
            tol="rel 1e-4 poses, 1e-3 covariances; counts and clocks exact; repeat bit-equal",
        )
        log(f"[kernel] {name}: rel errs {[f'{e:.2e}' for e in errs]}, "
            f"{int(got[4].sum())} matched rows, empty bucket count {int(got[4][2 * nb // 3])}, "
            f"gated-off bucket count {int(got[4][nb // 3])}")

    kargs = keys_inputs(torch, dev, rng)
    got = mg.keys_call(*kargs, 3, 1 << 14)
    again = mg.keys_call(*kargs, 3, 1 << 14)
    torch.cuda.synchronize()
    ref = mg.keys_plain(*kargs, 3, 1 << 14)
    # Keys, centres and probe starts are computed un-fused on both sides:
    # exact.  p_i/p_w rel 1e-6; covariances rel 1e-5 (FMAs in the sandwiches).
    for i in (2, 3, 4):
        if not torch.equal(got[i], ref[i]):
            raise RuntimeError(f"keys: output {i} differs in {(got[i] != ref[i]).sum()} entries")
    e_piw, e_cov = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
    if not (e_piw <= 1e-6 and e_cov <= 1e-5):
        raise RuntimeError(f"keys: rel errs piw {e_piw:.3g} covs {e_cov:.3g}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("keys: two launches on the same inputs differ")
    px = ptxas_entry("keys_kernel")
    log(f"[kernel] keys: a block of four warps a 32-row tile, {px['registers']} registers, "
        f"{px['spills']} B of spills, {px['stack']} B stack frame, {px['smem']} B static shared memory; "
        f"two launches bit-equal")
    if px["spills"]:
        raise RuntimeError(f"keys: ptxas spills {px['spills']} B")
    c = kargs[1].shape[1]
    recs["keys"] = dict(
        max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
        ms=time_call(torch, lambda: mg.keys_call(*kargs, 3, 1 << 14), 200),
        plain_ms=time_call(torch, lambda: mg.keys_plain(*kargs, 3, 1 << 14), 20),
        bytes=nbytes(list(kargs) + list(got)), flops=650.0 * c,  # ~650 flops a row
        tol="keys/centres/probe starts exact; rel 1e-6 points, 1e-5 covariances",
    )
    log(f"[kernel] keys: exact keys, rel errs piw {e_piw:.2e} covs {e_cov:.2e}")

    px = ptxas_entry("select_kernel")
    log(f"[kernel] select: one launch a call, {px['registers']} registers, {px['spills']} B of spills, "
        f"{px['stack']} B stack frame, {px['smem']} B static shared memory (its staging is dynamic, "
        f"sized at launch)")
    if px["spills"]:
        raise RuntimeError(f"select: ptxas spills {px['spills']} B")
    srng = np.random.default_rng(17)  # the later kernels' inputs stay as they were
    for name, nb in (("select", 28), ("select_56", 56)):
        sargs = select_inputs(torch, dev, rng if nb == 28 else srng, got, nb=nb)
        (out, s40, nm), (r_out, r_s40, r_nm), e = select_check(torch, sargs, 3, nb)
        # The same rows with their bucket indices shuffled (bucket 1 empty):
        # each bucket block gathers its rows wherever they lie.
        _, _, e_sh = select_check(torch, shuffled_bidx(torch, sargs, srng, empty=1), 3, nb)
        c = sargs[1].shape[1]
        same = out[0] == r_out[0]
        recs[name] = dict(
            max_abs_err=max(max_abs(out[:, same], r_out[:, same]), max_abs(s40, r_s40), max_abs(nm, r_nm)),
            ms=time_call(torch, lambda: mg.select_call(*sargs, 3, nb), 200),
            plain_ms=time_call(torch, lambda: mg.select_plain(*sargs, 3, nb), 10),
            bytes=nbytes(list(sargs) + [out, s40, nm]),
            flops=c * (6 * 200 + 80 + 820 * 3),  # 6 candidates, features, s40 sums
            tol=SELECT_TOL,
        )
        log(f"[kernel] {name}: NB = {nb}, {e['flips']} gate flips, rel errs rows {e['e_rows']:.2e} "
            f"sums {e['e_sum']:.2e} s40-vs-plain {e['e_s40']:.2e}; shuffled bidx, bucket 1 empty: "
            f"{e_sh['flips']} flips, rows {e_sh['e_rows']:.2e} sums {e_sh['e_sum']:.2e} "
            f"s40-vs-plain {e_sh['e_s40']:.2e}; two launches bit-equal")

    px = ptxas_entry("moments_kernel")
    log(f"[kernel] moments: a warp a 32-row tile, rows read by index, {px['registers']} registers, "
        f"{px['spills']} B of spills, {px['stack']} B stack frame, {px['smem']} B static shared memory")
    if px["spills"]:
        raise RuntimeError(f"moments: ptxas spills {px['spills']} B")
    margs = moments_inputs(torch, dev, rng)
    got = ir.moments_rows_call(*margs)
    again = ir.moments_rows_call(*margs)
    torch.cuda.synchronize()
    ref = ir.moments_rows_plain(*margs)
    got69, ref69 = torch.cat(got, dim=1), torch.cat(ref, dim=1)
    e_mom = max(rel_err(got69[:, i], ref69[:, i]) for i in range(69))
    if not e_mom <= 1e-4:  # per moment row, rel to its magnitude (FMAs)
        raise RuntimeError(f"moments: rel err {e_mom:.3g}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("moments: two launches on the same inputs differ")
    r, nb = margs[8].shape[0], margs[2].shape[0]
    recs["moments"] = dict(
        max_abs_err=max_abs(got69, ref69),
        ms=time_call(torch, lambda: ir.moments_rows_call(*margs), 200),
        plain_ms=time_call(torch, lambda: ir.moments_rows_plain(*margs), 20),
        bytes=moments_bytes(margs), flops=380.0 * r,  # ~380 flops a row
        tol="rel 1e-4 per moment row; repeat bit-equal",
    )
    log(f"[kernel] moments: R = {r}, NB = {nb}, rel err {e_mom:.2e}; two launches bit-equal")

    for frag, tag in (("fit_slots_kernelIf", "f32"), ("fit_slots_kernelI6__half", "f16"),
                      ("fit_slots_kernelI13__nv_bfloat16", "bf16")):
        px = ptxas_entry(frag)
        log(f"[kernel] fit ({tag} moms): an eigen warp and two contraction warps (eight lanes a slot) "
            f"a block of eight slots, {px['registers']} registers, "
            f"{px['spills']} B of spills, {px['stack']} B stack frame, {px['smem']} B static shared memory")
        if px["spills"]:
            raise RuntimeError(f"fit: ptxas spills {px['spills']} B in the {tag} instantiation")
    fargs, n_real = fit_inputs(torch, dev)
    got = pfr.fit_slots_call(*fargs)
    again = pfr.fit_slots_call(*fargs)
    torch.cuda.synchronize()
    ref = pfr.fit_slots_plain(*fargs)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("fit: non-finite output")
    if not torch.equal(got, again):
        raise RuntimeError("fit: two launches on the same inputs differ")
    # Kernel and plain version do the same un-fused arithmetic in the same
    # order; they can part only where sqrt, division or cos round apart.  A
    # slot counts as a branch flip when is_plane differs or the normal moved
    # by more than 1e-3 (another eigenvector candidate or fallback); at most
    # 2 of the 1024 may.  On the rest: centre, normal, evals, radius abs 1e-5,
    # plane_var 1e-4 of the row's largest entry.
    gt, rt = got.T, ref.T
    flip = (gt[34] != rt[34]) | ((gt[3:6] - rt[3:6]).abs().max(dim=0).values > 1e-3)
    n_flip = int(flip.sum())
    keep = ~flip
    e_head = max_abs(gt[0:10, keep], rt[0:10, keep])
    pv_scale = rt[10:31, keep].abs().max(dim=0).values.clamp(min=1e-30)
    e_pv = float(((gt[10:31, keep] - rt[10:31, keep]).abs().max(dim=0).values / pv_scale).max())
    if n_flip > 2 or not (e_head <= 1e-5 and e_pv <= 1e-4 and torch.equal(gt[31:34], rt[31:34])):
        raise RuntimeError(f"fit: {n_flip} branch flips, head err {e_head:.3g}, plane_var rel {e_pv:.3g}")
    b = fargs[4].shape[0]
    recs["fit"] = dict(
        max_abs_err=max_abs(gt[:, keep], rt[:, keep]),
        ms=time_call(torch, lambda: pfr.fit_slots_call(*fargs), 200),
        plain_ms=time_call(torch, lambda: pfr.fit_slots_plain(*fargs), 5),
        bytes=fit_bytes(fargs), flops=FIT_FLOPS_PER_SLOT * b,
        tol="<= 2 branch flips in 1024 slots; abs 1e-5 centre/normal/evals/radius; "
            "plane_var 1e-4 of the row's largest entry; repeat bit-equal",
    )
    log(f"[kernel] fit: {n_real} map rows + {b - n_real} sentinel rows, {int(rt[34].sum())} planes, "
        f"{n_flip} branch flips, head err {e_head:.2e}, plane_var rel {e_pv:.2e}, "
        f"bit-equal {bool(torch.equal(got, ref))}; two launches bit-equal")

    for spt in (1, 2):  # MP <= 1,024 (pose at 128, pose_384) and MP 1,025-2,048 (pose_1280)
        px = ptxas_entry(f"pose_kernelILi{spt}E")
        log(f"[kernel] pose: one block, {spt} slot(s) a thread, {px['registers']} registers, "
            f"{px['spills']} B of spills, {px['stack']} B stack frame")
        if px["spills"]:
            raise RuntimeError(f"pose: ptxas spills {px['spills']} B in pose_kernel<{spt}>")
    for name, (nb, k) in (("pose", (28, 1)), ("pose_384", (28, 12)), ("pose_1280", (256, 4))):
        pargs = pose_inputs(torch, dev, rng, nb, k)
        got = pp.pose_call(*pargs)
        torch.cuda.synchronize()
        ref = pp.pose_plain(*pargs)
        mp = pargs[1].shape[1]
        # The same operations in the same order on both sides: bit-equal.
        if not torch.equal(got, ref):
            raise RuntimeError(f"{name}: max abs err {max_abs(got, ref):.3g} at MP = {mp}: "
                               f"not bit-equal to the plain version")
        rec = dict(
            max_abs_err=max_abs(got, ref),
            ms=time_call(torch, lambda: pp.pose_call(*pargs), 200),
            plain_ms=time_call(torch, lambda: pp.pose_plain(*pargs), 5),
            bytes=nbytes(list(pargs) + [got]), flops=pose_flops(mp),
            tol="bit-equal",
        )
        log(f"[kernel] {name}: MP = {mp}, bit-equal")
        recs[name] = rec
    floor_ms = launch_floor_ms(torch)
    log(f"[floor] an empty kernel from the library: {floor_ms:.4f} ms a launch "
        f"(CUDA events, 200 launches queued behind the spin; the floor under every kernel ms above)")
    for name, rec in recs.items():
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"])
        log(f"[kernel] {name}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
            f"bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']}) tol: {rec['tol']}")
    return recs


def wrappers():
    from legkilo_torch.ops import chain_points as cp, chain_stats as cs, insert_rows as ir
    from legkilo_torch.ops import match_geom as mg, plane_fit_rows as pfr, pose_prop as pp

    return {"chain_stats": cs.chain_call, "keys": mg.keys_call, "select": mg.select_call,
            "moments": ir.moments_rows_call, "fit": pfr.fit_slots_call, "pose": pp.pose_call,
            "chain_points": cp.chain_points_call}


def reset_counters():
    for fn in wrappers().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in wrappers().items()}


def simulate(duration: float, tag: str):
    from legkilo_torch.models import sim

    t0 = time.perf_counter()
    data = sim.simulate(sim.SimConfig(duration=duration, scan_points=8000, seed=7))
    log(f"[{tag}] sim {duration} s: {len(data.scans)} scans in {time.perf_counter() - t0:.1f} s")
    return data


def path_config(five=True, points=False):
    """bench.py's configuration on the fused path (``five`` off: pose and
    refit in plain torch) or on the per-point path, and the set of wrappers
    whose kernels that path launches."""
    from legkilo_torch.runner import bench_config, bench_config_points

    if points:
        return bench_config_points(), POINTS_KERNELS
    cfg = bench_config()
    cfg.tpu.use_pallas_pose = cfg.tpu.use_pallas_refit = five
    return cfg, FUSED_KERNELS if five else FOUR_KERNELS


def run_workload(torch, data, tag: str, use_kin=False, five=True, chunk=0, latch=True,
                 points=False, edit=None, slides=False, config=None, keep=False, window=None):
    """One run_offline over ``data`` on the card.  ``five`` off leaves the
    pose and refit kernels out (plain torch); ``points`` takes the per-point
    path; ``config()`` gives a configuration and the wrappers its path
    launches in their place; ``chunk`` > 1 replays in chunks; ``latch`` off
    disables the escalation to iterated matching; ``edit(cfg)`` changes the
    configuration further and returns the wrappers its path leaves out;
    ``slides`` replays scan by scan (as run_offline streams) and counts the
    map slides, each seen as a move of the carry's last slide position, and
    fails on fewer than two; ``keep`` replays scan by scan too and keeps
    the poses and the final carry in the record (``poses``, ``carry``; not
    logged); ``window`` = (tag, n_warm, n_prof) replays scan by scan too
    and traces the card's activity over ``n_prof`` scans after ``n_warm``
    (``profile_window``; those scans are left out of ``ms_per_scan``).
    Fails on an ATE that is not finite or not under the golden bound, on a
    kernel of the path that never launched and on a kernel off the path
    that did."""
    from legkilo_torch.io.tum import ate_rmse
    from legkilo_torch.runner import OdometryRunner, replay, run_offline

    cfg, on_path = config() if config is not None else path_config(five, points)
    cfg.only_imu_use = not use_kin
    if not latch:
        cfg.tpu.escalate_after = 0
    if edit is not None:
        on_path = on_path - edit(cfg)
    events = data.kin if use_kin else data.imu
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_slides = 0
    prof = None
    if slides or keep or window:
        runner = OdometryRunner(cfg, device="cuda")
        last = runner.carry.last_slide_pos
        steps = replay(runner, data.scans, events)
        if window:
            for _ in itertools.islice(steps, window[1]):
                pass
            prof = profile_window(torch, runner, steps, window[2])
        for _ in steps:
            now = runner.carry.last_slide_pos
            n_slides += int(not torch.equal(now, last))
            last = now
        results = runner.results
    else:
        results = run_offline(cfg, data.scans, events, device="cuda", chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    n_timed = len(results)
    if prof is not None:
        wall -= prof.pop("wall_s")
        n_timed -= prof["scans"]
    _, gt = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    pairs = [(r.pos, gt[gtm[round(r.time, 6)]]) for r in results if round(r.time, 6) in gtm]
    ate = ate_rmse(np.stack([p for p, _ in pairs]), np.stack([g for _, g in pairs]), align=False)
    rec = dict(scans=len(results), ate_m=ate, ms_per_scan=wall / n_timed * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=counts)
    if slides:
        rec["slides"] = n_slides
    log(f"[{tag}] {json.dumps(rec)}")
    if prof is not None:
        log_profile(window[0], prof, prof.pop("rows"))
        rec["profile"] = prof
    if keep:
        rec["poses"] = [(r.rot, r.pos) for r in results]
        rec["carry"] = runner.carry
    if len(results) < 30:
        raise RuntimeError(f"{tag}: only {len(results)} scans")
    if slides and n_slides < 2:
        raise RuntimeError(f"{tag}: {n_slides} map slides, expected at least 2")
    if not np.isfinite(ate) or ate >= ATE_BOUND_M:
        raise RuntimeError(f"{tag}: ATE {ate:.4f} m >= {ATE_BOUND_M} m")
    missing = sorted(k for k in on_path if counts[k] <= 0)
    stray = sorted(k for k, v in counts.items() if v > 0 and k not in on_path)
    if missing or stray:
        raise RuntimeError(f"{tag}: kernels of the path never launched: {missing}; "
                           f"kernels off the path launched: {stray}")
    return rec


def cut(data, duration: float):
    """``data`` with its scans cut to the first ``duration`` seconds (the
    event streams stay whole; the replay stops at the last scan)."""
    import copy

    out = copy.copy(data)
    out.scans = data.scans[: int(duration * 10)]
    return out


def slide_edit(cfg):
    """The map slide (map_sliding_en, a threshold the path crosses several
    times) with the constant-velocity match pose, which takes the pose
    kernel off the path."""
    cfg.voxel_map.map_sliding_en = True
    cfg.voxel_map.sliding_thresh = SLIDE_THRESH_M
    cfg.voxel_map.half_map_size = SLIDE_HALF_MAP
    cfg.tpu.match_pose = "const_vel"
    return {"pose"}


def ref2ms_edit(cfg):
    """bench.py's 2 ms buckets (bench.py:350-366): NB = 56, P = 128."""
    cfg.tpu.bucket_quantum_ms = 2.0
    cfg.tpu.max_buckets = 56
    cfg.tpu.max_points_per_bucket = 128
    return set()


def sim_cli_config(path=None):
    """A configuration as ``python -m legkilo_torch sim`` loads it: the file
    as written (``Config()`` without one), with the sim rig's decimation
    (filter_num 1, blind 0.3)."""
    from legkilo_torch import config as config_mod

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = config_mod.load(os.path.join(root, path)) if path else config_mod.Config()
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    return cfg


def leg_fusion_config():
    """configs/leg_fusion.yaml: the fused path with every kernel switch at
    its default, off (NB 64, P 128, K 4, caps 4,096, 3 x 2^17 slots)."""
    return sim_cli_config("configs/leg_fusion.yaml"), set()


def mixed_config():
    """bench.py's configuration with the match kernels off: the match on
    its torch path feeding the chain, moments, pose and refit kernels."""
    from legkilo_torch.runner import bench_config

    cfg = bench_config()
    cfg.tpu.use_pallas_match = False
    return cfg, MIXED_KERNELS


def seq_config():
    """The default Config(): the sequential pipeline, IMU (NB 64, P 128)."""
    return sim_cli_config(), set()


def seq_kin_config():
    """configs/diter.yaml: the sequential pipeline with leg kinematics."""
    return sim_cli_config("configs/diter.yaml"), set()


def phase_repeat(torch, data):
    """``main``'s configuration streamed twice over the same scans: the
    trajectories and every final map table must be equal bit for bit (the
    map's scatter-adds are summed in row order on the card)."""
    a = run_workload(torch, data, "repeat", keep=True)
    b = run_workload(torch, data, "repeat", keep=True)
    same_traj = all(np.array_equal(ra, rb) and np.array_equal(pa, pb)
                    for (ra, pa), (rb, pb) in zip(a["poses"], b["poses"]))
    same_traj = same_traj and len(a["poses"]) == len(b["poses"])
    tables = {f: torch.equal(getattr(a["carry"].vm, f), getattr(b["carry"].vm, f))
              for f in ("ptab", "meta", "mom", "moms", "plane", "ocnt")}
    log(f"[repeat] trajectories equal {same_traj}; map tables equal {json.dumps(tables)}")
    if not same_traj or not all(tables.values()):
        raise RuntimeError("repeat: two runs of one configuration differ")


def device_rows(prof):
    """(device us, name, calls) for each operation the card ran (kernels and
    copies, so nothing counts twice) in a finished torch.profiler trace.
    Reads the profiler's raw events: building its Python event objects
    (``key_averages``) takes minutes for the ~10^5 launches a scan of the
    paths off the kernels, the raw events about a second."""
    by = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        us, n = by.get(e.name(), (0.0, 0))
        by[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((us, key, n) for key, (us, n) in by.items()), reverse=True)


def profile_window(torch, runner, steps, n_prof: int, host_ops=False):
    """Trace ``n_prof`` scans of the replay ``steps`` through ``runner`` with
    torch.profiler (the card's activity, and the host's with ``host_ops``),
    after flushing what came before.  Returns the window's scans, host wall
    (``wall_s`` in s, ``wall_ms_per_scan``), device busy ms and launches a
    scan, and the device ``rows``."""
    from torch.profiler import ProfilerActivity, profile

    runner.flush()
    torch.cuda.synchronize()
    n0 = len(runner.results)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in itertools.islice(steps, n_prof):
            pass
        runner.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    n = len(runner.results) - n0
    dev_ms = sum(r[0] for r in rows) / 1e3
    return dict(scans=n, wall_s=wall, wall_ms_per_scan=wall / n * 1e3,
                device_ms_per_scan=dev_ms / n, launches_per_scan=sum(r[2] for r in rows) / n,
                rows=rows)


def log_profile(tag: str, rec: dict, rows) -> None:
    n = rec["scans"]
    log(f"[{tag}] {n} scans: host wall {rec['wall_ms_per_scan']:.3f} ms/scan, device busy "
        f"{rec['device_ms_per_scan']:.3f} ms/scan "
        f"({100 * rec['device_ms_per_scan'] / rec['wall_ms_per_scan']:.1f}% of wall), "
        f"{rec['launches_per_scan']:.0f} device launches/scan")
    if not rows:
        log(f"[{tag}] device time: not measured (the profiler saw no CUDA activity)")
    for dev_us, key, count in rows[:12]:
        log(f"[{tag}]   {dev_us / n / 1e3:8.4f} ms/scan {count / n:6.1f} calls/scan  {key[:90]}")


def phase_profile(torch, tag: str, five=True, points=False, n_warm=10, n_prof=20):
    """torch.profiler over ``n_prof`` scans after ``n_warm`` warm-up scans,
    fed by run_offline's own replay loop: the device's busy share of the
    host wall clock, kernel launches a scan, and device time a scan by
    operator (ours and PyTorch's).  ``five`` off profiles the configuration
    without the pose and refit kernels, ``points`` the per-point path.
    (The paths off the kernels take their windows inside their own runs:
    ``run_workload(window=...)``.)"""
    from legkilo_torch.models import sim
    from legkilo_torch.runner import OdometryRunner, replay

    t_phase = time.perf_counter()
    data = sim.simulate(sim.SimConfig(duration=(n_warm + n_prof + 1) * 0.1, scan_points=8000, seed=7))
    cfg, _ = path_config(five, points)
    runner = OdometryRunner(cfg, device="cuda")
    steps = replay(runner, data.scans, data.imu)
    for _ in itertools.islice(steps, n_warm):
        pass
    rec = profile_window(torch, runner, steps, n_prof, host_ops=True)
    rec.pop("wall_s")
    log_profile(tag, rec, rec.pop("rows"))
    log(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,main,chunk,stream1,four,profile,kin,points,points_kin,"
                            "slide,points_chunk,ref2ms,repeat,leg_fusion,mixed,seq,seq_kin")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import legkilo_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the legkilo_torch package is not here ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = time.perf_counter()
    phase_build()
    recs = phase_kernels(torch, dev) if "kernels" in phases else {}
    main_rec = kin_rec = points_rec = points_kin_rec = ref2ms_rec = None
    if phases & {"main", "chunk", "stream1", "four", "points", "slide", "points_chunk", "ref2ms",
                  "repeat", "leg_fusion", "mixed", "seq", "seq_kin"}:
        data = simulate(MAIN_DURATION_S, "main")
        if "main" in phases:
            main_rec = run_workload(torch, data, "main")
        if "chunk" in phases:
            run_workload(torch, data, "chunk", chunk=CHUNK)
            log(f"[chunk] run_offline(chunk={CHUNK}) stages every packet on the host first; "
                f"its ms/scan includes that staging")
        if "stream1" in phases:
            run_workload(torch, data, "stream1", latch=False)
        if "points" in phases:
            points_rec = run_workload(torch, data, "points", points=True)
        if "four" in phases:
            run_workload(torch, cut(data, FOUR_DURATION_S), "four", five=False)
        extra = cut(data, EXTRA_DURATION_S)
        if "slide" in phases:
            run_workload(torch, extra, "slide", edit=slide_edit, slides=True)
        if "points_chunk" in phases:
            run_workload(torch, extra, "points_chunk", points=True, chunk=CHUNK)
        if "ref2ms" in phases:
            ref2ms_rec = run_workload(torch, extra, "ref2ms", chunk=CHUNK, edit=ref2ms_edit)
        if "repeat" in phases:
            phase_repeat(torch, cut(data, REPEAT_DURATION_S))
        if "leg_fusion" in phases:
            run_workload(torch, cut(data, SLOW_DURATION_S), "leg_fusion", use_kin=True,
                         config=leg_fusion_config,
                         window=("profile_leg_fusion", SLOW_WARM, SLOW_PROF))
        if "mixed" in phases:
            run_workload(torch, cut(data, MIXED_DURATION_S), "mixed", config=mixed_config)
        if "seq" in phases:
            run_workload(torch, cut(data, SLOW_DURATION_S), "seq", config=seq_config,
                         window=("profile_seq", SLOW_WARM, SLOW_PROF))
        if "seq_kin" in phases:
            run_workload(torch, cut(data, SLOW_DURATION_S), "seq_kin", use_kin=True,
                         config=seq_kin_config)
    if "profile" in phases:
        p4 = phase_profile(torch, "profile4", five=False)
        p5 = phase_profile(torch, "profile5")
        log(f"[profile] device launches/scan {p4['launches_per_scan']:.0f} -> "
            f"{p5['launches_per_scan']:.0f}, device busy ms/scan {p4['device_ms_per_scan']:.3f} -> "
            f"{p5['device_ms_per_scan']:.3f} (four -> five kernels)")
        if "points" in phases:
            pp_ = phase_profile(torch, "profile_points", points=True)
            log(f"[profile] per-point path: {pp_['launches_per_scan']:.0f} device launches/scan, "
                f"device busy {pp_['device_ms_per_scan']:.3f} ms/scan, host wall "
                f"{pp_['wall_ms_per_scan']:.3f} ms/scan")
    if phases & {"kin", "points_kin"}:
        kin_data = simulate(KIN_DURATION_S, "kin")
        if "kin" in phases:
            kin_rec = run_workload(torch, kin_data, "kin", use_kin=True)
        if "points_kin" in phases:
            points_kin_rec = run_workload(torch, kin_data, "points_kin", use_kin=True, points=True)
    log(f"[done] phases {sorted(phases)} in {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, rec in recs.items():
        if name in ("pose_384", "pose_1280"):  # off the main path's shape: held above, not listed
            continue
        # The run whose counters give the kernel's launches: each chain on
        # its own path's run, select at NB = 56 on the 2 ms bucket run, the
        # rest on the main path's.
        run, counter = {
            "select_56": (ref2ms_rec, "select"),
            "chain_stats_kin": (kin_rec, "chain_stats"),
            "chain_points": (points_rec, "chain_points"),
            "chain_points_kin": (points_kin_rec, "chain_points"),
        }.get(name, (main_rec, name))
        launches = run["launches"][counter] if run else 0
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
        })
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
