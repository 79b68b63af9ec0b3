#!/usr/bin/env python3
"""The three ways to run insert_points_hinted's claim in eager torch, timed on the card.

The JAX package claims the new keys of an ungated hinted insert under
``lax.cond(n_new <= insert_new_cap, fast, slow)``: ``fast`` compacts the
new keys to ``insert_new_cap`` rows and claims over those, ``slow`` claims
over every row.  Both give the same table (the claims keep their relative
order).  In eager torch the choice can be made three ways:

* ``series``: one claim series over every row, the new keys active (what
  ``legkilo_torch.core.voxel_map.insert_points_hinted`` runs);
* ``sync``: read ``n_new`` back to the host (one sync), then the compacted
  claim or the full one;
* ``both``: run both claims and select on the card.

This script builds a map of configs/leg_fusion.yaml's size (three levels
of 2^17 slots, probe 8, six claim rounds) from seeded points, then times the
three on 4,096 points to insert (3 x 4,096 rows; 2 % of the points where
the map has no voxel, ~250 new rows, under the default ``insert_new_cap``
of 512; then 25 %, ~3,000 new rows, over it) with CUDA events and the host
clock, in turns, and checks that all three give ``torch.equal`` tables and
slots.

    python3 tools/claim_ab.py          # card only, ~1 min
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from legkilo_torch.core import voxel_map as vm  # noqa: E402

NEW_CAP = 512


def with_sentinel(ptab):
    """A copy of ptab with a zero sentinel row (each way claims on its own
    copy: ``vm._with_sentinel`` would hand an insert's table back in place)."""
    return torch.cat([ptab, torch.zeros_like(ptab[:1])])


def claim_series(ptab, cfg, keys, lvl, need, slot0):
    ptab_x, slot_c, ok_c = vm._find_or_insert_flat(with_sentinel(ptab), keys, lvl, need, cfg)
    return ptab_x, torch.where(ok_c, slot_c, slot0)


def claim_compact(ptab, cfg, keys, lvl, need, slot0):
    miss = cfg.levels * cfg.capacity
    order = vm.compact_order(need, NEW_CAP)
    k_c = vm._gather_fill(keys, order, 0)
    l_c = vm._gather_fill(lvl, order, 0)
    a_c = vm._gather_fill(need, order, False)
    ptab_x, slot_c, ok_c = vm._find_or_insert_flat(with_sentinel(ptab), k_c, l_c, a_c, cfg)
    slot = torch.cat([slot0, slot0.new_full((1,), miss)])
    slot[order] = torch.where(ok_c, slot_c, miss)
    return ptab_x, slot[:-1]


def claim_sync(ptab, cfg, keys, lvl, need, slot0):
    if int(need.sum()) <= NEW_CAP:
        return claim_compact(ptab, cfg, keys, lvl, need, slot0)
    return claim_series(ptab, cfg, keys, lvl, need, slot0)


def claim_both(ptab, cfg, keys, lvl, need, slot0):
    fast = claim_compact(ptab, cfg, keys, lvl, need, slot0)
    slow = claim_series(ptab, cfg, keys, lvl, need, slot0)
    pick = need.sum() <= NEW_CAP
    return tuple(torch.where(pick, a, b) for a, b in zip(fast, slow))


VARIANTS = {"series": claim_series, "sync": claim_sync, "both": claim_both}


def case(cfg, dev, rng, n_new_frac):
    """A map of 20 k points and 4,096 points to insert, ``n_new_frac`` of
    which lie where the map has no voxel; returns the claim's inputs."""
    n_map = 20000
    pts = rng.uniform(-30, 30, size=(n_map, 3)).astype(np.float32)
    var = np.tile(np.eye(3, dtype=np.float32) * 1e-4, (n_map, 1, 1))
    mask = np.ones(n_map, dtype=bool)
    m = vm.make_map(cfg, dev)
    for lo in range(0, n_map, 5000):
        sl = slice(lo, lo + 5000)
        m = vm.insert_points(m, cfg, *(torch.from_numpy(x[sl]).to(dev) for x in (pts, var, mask)))
    n = 4096
    old = pts[rng.integers(0, n_map, size=n)]
    new = rng.uniform(40, 60, size=(n, 3)).astype(np.float32)
    q = np.where((rng.random(n) < n_new_frac)[:, None], new, old)
    qm = torch.ones(n, dtype=torch.bool, device=dev)
    qt = torch.from_numpy(q).to(dev)
    mr = vm.match_points(m, cfg, qt, torch.from_numpy(np.tile(var[:1], (n, 1, 1))).to(dev), qm)
    L = cfg.levels
    keys = mr.own_keys.reshape(L * n, 3)
    lvl = torch.arange(L, dtype=torch.int64, device=dev).repeat_interleave(n)
    mask_f = qm.repeat(L)
    found = mr.own_found.reshape(L * n) & mask_f
    slot0 = torch.where(found, mr.own_slot.reshape(L * n).to(torch.int64), L * cfg.capacity)
    return m.ptab, keys, lvl, mask_f & ~found, slot0


def main() -> int:
    if not torch.cuda.is_available():
        print("claim_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}")
    dev = torch.device("cuda")
    cfg = vm.MapConfig(levels=3, capacity=1 << 17, probe=8, voxel_size=0.5, planer_threshold=0.01,
                       sigma_num=3.0, max_points_num=50, init_num=(5, 5, 5), insert_rounds=6,
                       refit_budget=2048)
    rng = np.random.default_rng(7)
    for frac in (0.02, 0.25):
        args = case(cfg, dev, rng, frac)
        n_new = int(args[3].sum())
        outs = {k: f(*args[:1], cfg, *args[1:]) for k, f in VARIANTS.items()}
        # The tables without their sentinel row (duplicate claims aimed at a
        # miss all land there; it is cut off after the insert).
        same = all(torch.equal(o[0][:-1], outs["series"][0][:-1]) and torch.equal(o[1], outs["series"][1])
                   for o in outs.values())
        times = {k: [] for k in VARIANTS}
        for _ in range(5):
            for k, f in VARIANTS.items():
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                f(args[0], cfg, *args[1:])
                e1.record()
                torch.cuda.synchronize()
                times[k].append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3))
        line = ", ".join(f"{k} {np.median([t[0] for t in v]):.3f} ms events / "
                         f"{np.median([t[1] for t in v]):.3f} ms host" for k, v in times.items())
        print(f"[claim] {n_new} new rows of {args[1].shape[0]} (insert_new_cap {NEW_CAP}): {line}; "
              f"outputs torch.equal {same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
