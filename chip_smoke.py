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
   pose kernel at MP = 384 too),
   held against its plain PyTorch version on the same inputs within the
   stated tolerance, and timed with CUDA events (kernel and plain version).
   The refit rows are those of a short run's map plus zero padding, and the
   slots on which kernel and plain version took different branches are
   counted.
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

Each run sets every launch counter to 0 before and reads it after: the
kernels of the path it drives must have launched, and the others must not.

The last two lines are a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result; so does a machine without CUDA, or a
directory holding this script without the package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

ATE_BOUND_M = 0.08
MAIN_DURATION_S = 24.0   # bench.py's workload, uncut
FOUR_DURATION_S = 8.0    # the four-kernel configuration, cut
KIN_DURATION_S = 4.0     # 40 scans of the kin branch
CHUNK = 32               # bench.py:190
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 on CUDA cores, H100 SXM data sheet
REPLACES = {
    "chain_stats": "legkilo_tpu/ops/pallas/chain_stats.py:348",
    "chain_stats_kin": "legkilo_tpu/ops/pallas/chain_stats.py:348",
    "keys": "legkilo_tpu/ops/pallas/match_geom.py:74",
    "select": "legkilo_tpu/ops/pallas/match_geom.py:254",
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
    "moments": "legkilo_torch/csrc/insert_rows.cu",
    "fit": "legkilo_torch/csrc/plane_fit_rows.cu",
    "pose": "legkilo_torch/csrc/pose_prop.cu",
    "chain_points": "legkilo_torch/csrc/chain_points.cu",
    "chain_points_kin": "legkilo_torch/csrc/chain_points.cu",
}
# The wrappers whose kernels each path launches (counter names of wrappers()).
FUSED_KERNELS = {"chain_stats", "keys", "select", "moments", "fit", "pose"}
FOUR_KERNELS = FUSED_KERNELS - {"fit", "pose"}
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


def select_sums_vs_plain(torch, out, s40, nm, r_out, r_s40, r_nm, bidx, nb):
    """The select kernel's per-bucket s40 and match counts against the plain
    version's, with the terms of the rows whose gate flipped (matched on one
    side only) taken out of each side's sums in float64.  Returns (rel err
    of s40, whether the counts agree)."""
    flip = out[0] != r_out[0]
    b = bidx[0].long()[flip]
    tgt = torch.where(b < nb, b, torch.full_like(b, nb))

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


def moments_inputs(torch, dev, rng, r=4096):
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    par = np.zeros(16)
    par[0:9] = rotations(rng, 1, 0.05)[0].reshape(9)
    p_i = rng.uniform(-10, 10, size=(r, 3))
    a = rng.normal(size=(r, 3, 3)) * 0.01
    bc = a @ np.swapaxes(a, 1, 2)
    rb = rotations(rng, r, 0.3).reshape(r, 9)
    pb = rng.normal(scale=2.0, size=(r, 3))
    b = rng.normal(size=(r, 3, 3)) * 1e-3
    c = rng.normal(size=(r, 3, 3)) * 1e-3
    brow = np.concatenate([rb, pb, (b @ np.swapaxes(b, 1, 2)).reshape(r, 9),
                           (c @ np.swapaxes(c, 1, 2)).reshape(r, 9)], 1)
    size = 0.5 / 2.0 ** rng.integers(0, 3, size=r)
    pw = np.einsum("rij,rj->ri", rb.reshape(r, 3, 3), p_i) + pb
    key = np.floor(pw / size[:, None])
    prow = np.concatenate([p_i, bc.reshape(r, 9)], 1)
    return f(par), f(prow.T), f(brow.T), f(key.T), f(size[None])


def fit_inputs(torch, dev, budget=1024, n_scans=30):
    """Refit rows as the insert forms them: the moment and meta rows of the
    voxels a short five-kernel run left in its map with more points than the
    refit threshold (at most 5/8 of the budget, about the share a
    steady-state scan refits), then zero rows up to the budget, as the
    unfilled refit slots are."""
    from legkilo_torch.models import sim
    from legkilo_torch.runner import OdometryRunner, bench_config, replay

    data = sim.simulate(sim.SimConfig(duration=(n_scans + 1) * 0.1, scan_points=8000, seed=7))
    runner = OdometryRunner(bench_config(), device=dev)
    for _ in replay(runner, data.scans, data.imu):
        pass
    vm = runner.carry.vm
    idx = torch.nonzero(vm.meta[:, 0] > 5.0)[:, 0][: budget * 5 // 8]
    mom = torch.zeros((budget, 69), dtype=torch.float32, device=dev)
    meta = torch.zeros((budget, 4), dtype=torch.float32, device=dev)
    mom[: len(idx)] = torch.cat([vm.mom[idx], vm.moms[idx].float()], dim=1)
    meta[: len(idx)] = vm.meta[idx]
    par = torch.zeros(8, dtype=torch.float32, device=dev)
    par[0] = runner.scfg.map_cfg.planer_threshold
    return (par, mom.T.contiguous(), meta.T.contiguous()), int(len(idx))


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
        args = chain_inputs(torch, dev, rng, use_kin)
        got = cs.chain_call(*args, use_kin=use_kin)
        torch.cuda.synchronize()
        ref = cs.chain_plain(*args, use_kin=use_kin)
        # Poses: rel 1e-4 of their magnitude; covariances: rel 1e-3 (the
        # plain version applies F P F^T as columns-then-rows, the kernel as
        # Q1 + (D Q1^T)^T, and the 18x18 inverse amplifies rounding).
        tol = [1e-4, 1e-4, 1e-3, 1e-3, 0.0, 1e-4, 1e-4, 1e-3, 0.0]
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        for i, (e, t) in enumerate(zip(errs, tol)):
            if not e <= t:
                raise RuntimeError(f"{name}: output {i} rel err {e:.3g} > {t}")
        nb, k = args[6].shape
        recs[name] = dict(
            max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
            ms=time_call(torch, lambda: cs.chain_call(*args, use_kin=use_kin), 50),
            plain_ms=time_call(torch, lambda: cs.chain_plain(*args, use_kin=use_kin), 3),
            bytes=nbytes(list(args) + list(got)), flops=chain_flops(nb, k, use_kin),
            tol="rel 1e-4 poses, 1e-3 covariances",
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
        # products, the kernel as Q1 + (D Q1^T)^T and a fixed-order tree over
        # the points); match counts and clocks exact.
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
    c = kargs[1].shape[1]
    recs["keys"] = dict(
        max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
        ms=time_call(torch, lambda: mg.keys_call(*kargs, 3, 1 << 14), 200),
        plain_ms=time_call(torch, lambda: mg.keys_plain(*kargs, 3, 1 << 14), 20),
        bytes=nbytes(list(kargs) + list(got)), flops=650.0 * c,  # ~650 flops a row
        tol="keys/centres/probe starts exact; rel 1e-6 points, 1e-5 covariances",
    )
    log(f"[kernel] keys: exact keys, rel errs piw {e_piw:.2e} covs {e_cov:.2e}")

    sargs = select_inputs(torch, dev, rng, got)
    out, s40, nm = mg.select_call(*sargs, 3, 28)
    torch.cuda.synchronize()
    r_out, r_s40, r_nm = mg.select_plain(*sargs, 3, 28)
    # Rows: a gate (rsqrt/exp/sqrt differ in the last ulp) may flip only on
    # a knife edge; allow 1 row in 1000, compare the rest at rel 1e-4.
    same = out[0] == r_out[0]
    if float(same.float().mean()) < 0.999:
        raise RuntimeError(f"select: matched differs on {int((~same).sum())} rows")
    e_rows = rel_err(out[:, same], r_out[:, same])
    # Sums: the kernel's s40/nm against float64 sums of its own rows (order
    # of summation only), and against the plain version's, always: the
    # flipped rows' terms are taken out of both sides.
    x = out[6:46].double()
    b = sargs[7][0].long()
    tgt = torch.where(b < 28, b, torch.full_like(b, 28))
    s64 = torch.zeros(29, 40, 40, dtype=torch.float64, device=dev).index_add_(
        0, tgt, (x * out[1].double()).T[:, :, None] * x.T[:, None, :])[:28].reshape(28 * 40, 40)
    e_sum = rel_err(s40, s64)
    nm64 = torch.zeros(29, dtype=torch.float64, device=dev).index_add_(0, tgt, out[0].double())[:28]
    if not (e_rows <= 1e-4 and e_sum <= 1e-5 and torch.equal(nm[:, 0].double(), nm64)):
        raise RuntimeError(f"select: rel errs rows {e_rows:.3g} sums {e_sum:.3g}")
    e_s40, nm_same = select_sums_vs_plain(torch, out, s40, nm, r_out, r_s40, r_nm, sargs[7], 28)
    if not (e_s40 <= 1e-4 and nm_same):
        raise RuntimeError(f"select: vs plain: s40 rel err {e_s40:.3g}, counts equal {nm_same}")
    c = sargs[1].shape[1]
    recs["select"] = dict(
        max_abs_err=max(max_abs(out[:, same], r_out[:, same]), max_abs(s40, r_s40), max_abs(nm, r_nm)),
        ms=time_call(torch, lambda: mg.select_call(*sargs, 3, 28), 200),
        plain_ms=time_call(torch, lambda: mg.select_plain(*sargs, 3, 28), 10),
        bytes=nbytes(list(sargs) + [out, s40, nm]),
        flops=c * (6 * 200 + 80 + 820 * 3),  # 6 candidates, features, s40 sums
        tol="matched on >= 99.9% rows; rel 1e-4 rows; sums rel 1e-5 vs float64 of its rows "
            "and rel 1e-4 vs plain (flipped rows' terms out), counts exact",
    )
    log(f"[kernel] select: {int((~same).sum())} gate flips, rel errs rows {e_rows:.2e} "
        f"sums {e_sum:.2e} s40-vs-plain {e_s40:.2e}")

    margs = moments_inputs(torch, dev, rng)
    got = ir.moments_call(*margs)
    torch.cuda.synchronize()
    ref = ir.moments_plain(*margs)
    e_mom = max(rel_err(got[i], ref[i]) for i in range(69))
    if not e_mom <= 1e-4:  # per moment row, rel to its magnitude (FMAs)
        raise RuntimeError(f"moments: rel err {e_mom:.3g}")
    r = margs[1].shape[1]
    recs["moments"] = dict(
        max_abs_err=max_abs(got, ref),
        ms=time_call(torch, lambda: ir.moments_call(*margs), 200),
        plain_ms=time_call(torch, lambda: ir.moments_plain(*margs), 20),
        bytes=nbytes(list(margs) + [got]), flops=380.0 * r,  # ~380 flops a row
        tol="rel 1e-4 per moment row",
    )
    log(f"[kernel] moments: rel err {e_mom:.2e}")

    fargs, n_real = fit_inputs(torch, dev)
    got = pfr.fit_rows_call(*fargs)
    torch.cuda.synchronize()
    ref = pfr.fit_rows_plain(*fargs)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("fit: non-finite output")
    # Kernel and plain version do the same un-fused arithmetic in the same
    # order; they can part only where sqrt, division or cos round apart.  A
    # slot counts as a branch flip when is_plane differs or the normal moved
    # by more than 1e-3 (another eigenvector candidate or fallback); at most
    # 2 of the 1024 may.  On the rest: centre, normal, evals, radius abs 1e-5,
    # plane_var 1e-4 of the row's largest entry.
    flip = (got[34] != ref[34]) | ((got[3:6] - ref[3:6]).abs().max(dim=0).values > 1e-3)
    n_flip = int(flip.sum())
    keep = ~flip
    e_head = max_abs(got[0:10, keep], ref[0:10, keep])
    pv_scale = ref[10:31, keep].abs().max(dim=0).values.clamp(min=1e-30)
    e_pv = float(((got[10:31, keep] - ref[10:31, keep]).abs().max(dim=0).values / pv_scale).max())
    if n_flip > 2 or not (e_head <= 1e-5 and e_pv <= 1e-4 and torch.equal(got[31:34], ref[31:34])):
        raise RuntimeError(f"fit: {n_flip} branch flips, head err {e_head:.3g}, plane_var rel {e_pv:.3g}")
    b = fargs[1].shape[1]
    recs["fit"] = dict(
        max_abs_err=max_abs(got[:, keep], ref[:, keep]),
        ms=time_call(torch, lambda: pfr.fit_rows_call(*fargs), 200),
        plain_ms=time_call(torch, lambda: pfr.fit_rows_plain(*fargs), 5),
        bytes=nbytes(list(fargs) + [got]), flops=FIT_FLOPS_PER_SLOT * b,
        tol="<= 2 branch flips in 1024 slots; abs 1e-5 centre/normal/evals/radius; "
            "plane_var 1e-4 of the row's largest entry",
    )
    log(f"[kernel] fit: {n_real} map rows + {b - n_real} zero rows, {int(ref[34].sum())} planes, "
        f"{n_flip} branch flips, head err {e_head:.2e}, plane_var rel {e_pv:.2e}, "
        f"bit-equal {bool(torch.equal(got, ref))}")

    for name, (nb, k) in (("pose", (28, 1)), ("pose_384", (28, 12))):
        pargs = pose_inputs(torch, dev, rng, nb, k)
        got = pp.pose_call(*pargs)
        torch.cuda.synchronize()
        ref = pp.pose_plain(*pargs)
        mp = pargs[1].shape[1]
        # The JAX package's own kernel-vs-XLA tolerance (rtol 1e-5, atol 1e-6).
        if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"{name}: max abs err {max_abs(got, ref):.3g} at MP = {mp}")
        rec = dict(
            max_abs_err=max_abs(got, ref),
            ms=time_call(torch, lambda: pp.pose_call(*pargs), 200),
            plain_ms=time_call(torch, lambda: pp.pose_plain(*pargs), 5),
            bytes=nbytes(list(pargs) + [got]), flops=pose_flops(mp),
            tol="rtol 1e-5, atol 1e-6",
        )
        log(f"[kernel] {name}: MP = {mp}, max abs err {rec['max_abs_err']:.2e}, "
            f"bit-equal {bool(torch.equal(got, ref))}")
        recs[name] = rec
    for name, rec in recs.items():
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"])
        log(f"[kernel] {name}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
            f"bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']}) tol: {rec['tol']}")
    return recs


def wrappers():
    from legkilo_torch.ops import chain_points as cp, chain_stats as cs, insert_rows as ir
    from legkilo_torch.ops import match_geom as mg, plane_fit_rows as pfr, pose_prop as pp

    return {"chain_stats": cs.chain_call, "keys": mg.keys_call, "select": mg.select_call,
            "moments": ir.moments_call, "fit": pfr.fit_rows_call, "pose": pp.pose_call,
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
                 points=False):
    """One run_offline over ``data`` on the card.  ``five`` off leaves the
    pose and refit kernels out (plain torch); ``points`` takes the per-point
    path; ``chunk`` > 1 replays in chunks; ``latch`` off disables the
    escalation to iterated matching.  Fails on an ATE that is not finite or
    not under the golden bound, on a kernel of the path that never launched
    and on a kernel off the path that did."""
    from legkilo_torch.io.tum import ate_rmse
    from legkilo_torch.runner import run_offline

    cfg, on_path = path_config(five, points)
    cfg.only_imu_use = not use_kin
    if not latch:
        cfg.tpu.escalate_after = 0
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_offline(cfg, data.scans, data.kin if use_kin else data.imu, device="cuda",
                          chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    _, gt = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    pairs = [(r.pos, gt[gtm[round(r.time, 6)]]) for r in results if round(r.time, 6) in gtm]
    ate = ate_rmse(np.stack([p for p, _ in pairs]), np.stack([g for _, g in pairs]), align=False)
    rec = dict(scans=len(results), ate_m=ate, ms_per_scan=wall / len(results) * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=counts)
    log(f"[{tag}] {json.dumps(rec)}")
    if len(results) < 30:
        raise RuntimeError(f"{tag}: only {len(results)} scans")
    if not np.isfinite(ate) or ate >= ATE_BOUND_M:
        raise RuntimeError(f"{tag}: ATE {ate:.4f} m >= {ATE_BOUND_M} m")
    missing = sorted(k for k in on_path if counts[k] <= 0)
    stray = sorted(k for k, v in counts.items() if v > 0 and k not in on_path)
    if missing or stray:
        raise RuntimeError(f"{tag}: kernels of the path never launched: {missing}; "
                           f"kernels off the path launched: {stray}")
    return rec


def phase_profile(torch, tag: str, five=True, points=False, n_warm=10, n_prof=20):
    """torch.profiler over ``n_prof`` scans after ``n_warm`` warm-up scans,
    fed by run_offline's own replay loop: the device's busy share of the
    host wall clock, kernel launches a scan, and device time a scan by
    operator (ours and PyTorch's).  ``five`` off profiles the configuration
    without the pose and refit kernels, ``points`` the per-point path."""
    import itertools

    from torch.profiler import ProfilerActivity, profile

    from legkilo_torch.models import sim
    from legkilo_torch.runner import OdometryRunner, replay

    data = sim.simulate(sim.SimConfig(duration=(n_warm + n_prof + 1) * 0.1, scan_points=8000, seed=7))
    cfg, _ = path_config(five, points)
    runner = OdometryRunner(cfg, device="cuda")
    steps = replay(runner, data.scans, data.imu)
    for _ in itertools.islice(steps, n_warm):
        pass
    runner.flush()
    torch.cuda.synchronize()
    n0 = len(runner.results)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in steps:
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(runner.results) - n0
    rows = []  # device-side events only (kernels and copies), so nothing counts twice
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    log(f"[{tag}] {n} scans: host wall {wall / n * 1e3:.3f} ms/scan, device busy "
        f"{dev_ms / n:.3f} ms/scan ({100 * dev_ms / (wall * 1e3):.1f}% of wall), "
        f"{launches / n:.0f} device launches/scan")
    if not rows:
        log(f"[{tag}] device time: not measured (the profiler saw no CUDA activity)")
    for dev_us, key, count in rows[:12]:
        log(f"[{tag}]   {dev_us / n / 1e3:8.4f} ms/scan {count / n:6.1f} calls/scan  {key[:90]}")
    return dict(scans=n, wall_ms_per_scan=wall / n * 1e3, device_ms_per_scan=dev_ms / n,
                launches_per_scan=launches / n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,main,chunk,stream1,four,profile,kin,points,points_kin")
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
    main_rec = kin_rec = points_rec = points_kin_rec = None
    if phases & {"main", "chunk", "stream1", "four", "points"}:
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
            n = int(FOUR_DURATION_S * 10)
            data.scans = data.scans[:n]
            run_workload(torch, data, "four", five=False)
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
        if name == "pose_384":  # off the main path's shape: held above, not listed
            continue
        # The run whose counters give the kernel's launches: each chain on
        # its own path's run, the rest on the main path's.
        run, counter = {
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
