"""The comparison that decides ``correct``: the fleet's sampled calls
against the plain reference (portbench/reference/).

The reference works out, from the raw scans and events, what the port
derives from them: the packets, the first-frame initialisation and each
replica's jitter.  A filter's steps feed back on its own state (matches
depend on the pose, the pose on the matches and the map), so a float32
program and a float64 reference drift apart over a sequence.  The
reference therefore follows the fleet call by call: from a sampled
replica's state and map as the fleet held them before the call (copied to
the host in the window), it runs the call's scans, and is compared with
what the fleet held after the call and with the poses and match counts it
read back.  The start is checked by itself: the fleet's state and map
before a trial's first call against the reference's own first frame.
The fleet's map is read from its tables: a voxel is an occupied slot, its
level the slot's table, its key the slot's key.

Each number is the worst over the sampled calls and replicas:

- ``init_state_gap``: the start's rotation, linear state and covariance,
  the largest |difference|;
- ``init_map_slots``, ``init_mom_gap_rel``, ``init_plane_flips``: the
  start's map, as ``map_slots``, ``map_mom_gap_rel`` and ``plane_flips``;
- ``pos_gap_m``: the read-back position of the call's first scan, metres;
- ``vel_gap_mps``: after a call, the velocity, m/s;
- ``rot_gap``: after a call, the rotation matrix, largest entry;
- ``cov_gap_rel``: after a call, the covariance, over its largest entry;
- ``match_gap_rel``: the call's first scan's matched points, |difference|
  over the reference's count (a chunk's later scans run from states that
  have drifted apart);
- ``map_slots``: after a call, the share of the voxels of either map that
  the other lacks or whose point count, count since the last fit or
  plane flag differ;
- ``map_mom_gap_rel``: after a call, on the voxels that agree, the point
  moments (sum p, sum p p^T) and the covariance moments (sum V, V (x) p,
  V (x) p p^T), each over the reference's largest entry;
- ``plane_flips``: after a call, the share of the voxels that agree and
  are planes in both, their normal fixed by the points (the reference's
  two least eigenvalues at least a hundredth of the largest apart), whose
  plane moved: its centre by more than 1e-4 m or its normal (or the
  opposite normal) by more than 1e-3.

A cell compares the numbers its limits file (``limits/<cell>.json``)
lists; PERF.md gives each limit with the readings it was set from, and
why a cell leaves a number out.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from .reference import filter as rfilter
from .reference import inputs as rinputs
from .reference.arith import Arith
from .reference.eskf import POS, VEL, Filter
from .reference.voxels import VoxelMap

NUMBERS = ("init_state_gap", "init_map_slots", "init_mom_gap_rel", "init_plane_flips",
           "pos_gap_m", "vel_gap_mps", "rot_gap", "cov_gap_rel", "match_gap_rel",
           "map_slots", "map_mom_gap_rel", "plane_flips")
PLANE_CENTRE_M, PLANE_NORMAL, PLANE_POSED = 1e-4, 1e-3, 1e-2

# The port's packed map rows (legkilo_torch/core/voxel_map.py's module doc):
# symmetric 3x3 blocks keep (0,0) (0,1) (0,2) (1,1) (1,2) (2,2); plane_var
# its upper triangle row by row.
SYM6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
TRI21 = tuple((i, j) for i in range(6) for j in range(i, 6))


def _worst(a: float, b: float) -> float:
    """The larger of two readings; NaN (a non-finite output) wins."""
    return a if (a != a or a > b) else b


def load_limits(root: str, cell: str) -> Dict[str, float]:
    path = os.path.join(root, "portbench", "limits", f"{cell}.json")
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def _sym3(rows: np.ndarray) -> np.ndarray:
    """[..., 6] packed symmetric -> [..., 3, 3]."""
    out = np.zeros(rows.shape[:-1] + (3, 3))
    for k, (i, j) in enumerate(SYM6):
        out[..., i, j] = out[..., j, i] = rows[..., k]
    return out


def program_map(snap: dict, cfg: rfilter.Cfg, ar: Arith) -> VoxelMap:
    """The fleet's map of one replica (its occupied slots: ``slot``, and the
    rows of ``ptab``, ``meta``, ``mom``, ``moms``, ``plane``) as a
    reference map."""
    cap = 1 << int(cfg.s["tpu_map_capacity_log2"])
    slot = np.asarray(snap["slot"], dtype=np.int64)
    lk = np.concatenate([(slot // cap)[:, None], np.asarray(snap["ptab"])[:, 0:3]], axis=1)
    vm = VoxelMap(cfg.map, ar, rows=max(len(slot), 1))
    rows = vm.add_voxels(lk.astype(np.int64))
    t = vm.t
    meta = np.asarray(snap["meta"], dtype=np.float64)
    mom = np.asarray(snap["mom"], dtype=np.float64)
    moms = np.asarray(snap["moms"], dtype=np.float64)
    plane = np.asarray(snap["plane"], dtype=np.float64)
    t["n"][rows], t["new"][rows], t["init"][rows], t["plane"][rows] = meta.T
    t["m1"][rows] = mom[:, 0:3]
    t["m2"][rows] = _sym3(mom[:, 3:9])
    t["s0"][rows] = _sym3(moms[:, 0:6])
    s1 = moms[:, 6:24].reshape(-1, 6, 3)
    s2 = moms[:, 24:60].reshape(-1, 6, 6)
    for k, (i, j) in enumerate(SYM6):
        t["s1"][rows, i, j] = t["s1"][rows, j, i] = s1[:, k]
        t["s2"][rows, i, j] = t["s2"][rows, j, i] = _sym3(s2[:, k])
    t["centre"][rows], t["normal"][rows] = plane[:, 0:3], plane[:, 3:6]
    t["evals"][rows], t["radius"][rows] = plane[:, 6:9], plane[:, 9]
    for k, (i, j) in enumerate(TRI21):
        t["pv"][rows, i, j] = t["pv"][rows, j, i] = plane[:, 10 + k]
    return vm


def program_filter(snap: dict, ar: Arith) -> Filter:
    return Filter(ar.f(snap["rot"]), ar.f(snap["lin"]), ar.f(snap["cov"]),
                  float(snap["lp"]), float(snap["lu"]))


class Seen(NamedTuple):
    """What one replica of a sampled call gave: its start (the trial's first
    call only), its state and map after the call, the first scan's
    position and each scan's match count."""

    start: Optional[tuple]   # (Filter, VoxelMap)
    after: tuple
    pos0: np.ndarray
    n_matched: List[int]


def map_gaps(a: VoxelMap, r: VoxelMap) -> Dict[str, float]:
    """Map ``a`` against the reference's ``r`` (module doc)."""
    both = [k for k in a.index if k in r.index]
    union = len(a.index) + len(r.index) - len(both)
    ia = np.asarray([a.index[k] for k in both], dtype=np.int64)
    ir = np.asarray([r.index[k] for k in both], dtype=np.int64)
    ta, tr = a.t, r.t
    agree = ((ta["n"][ia] == tr["n"][ir]) & (ta["new"][ia] == tr["new"][ir])
             & ((ta["plane"][ia] > 0.5) == (tr["plane"][ir] > 0.5)))
    slots = (union - int(agree.sum())) / max(union, 1)
    ia, ir = ia[agree], ir[agree]
    mom = 0.0
    for names in (("m1", "m2"), ("s0", "s1", "s2")):
        gap = max((float(np.abs(ta[k][ia] - tr[k][ir]).max()) if len(ia) else 0.0) for k in names)
        top = max((float(np.abs(tr[k][ir]).max()) if len(ir) else 0.0) for k in names)
        mom = _worst(mom, gap / max(top, 1e-30))
    # A line-like voxel's normal is any direction across the line: float32
    # and float64 fits pick it apart.  Planes whose normal the points fix
    # (the two least eigenvalues a hundredth of the largest apart) count.
    ev = tr["evals"][ir]
    posed = (ev[:, 1] - ev[:, 0]) >= PLANE_POSED * ev[:, 2]
    planes = (ta["plane"][ia] > 0.5) & (tr["plane"][ir] > 0.5) & posed
    ia, ir = ia[planes], ir[planes]
    flips = 0.0
    if len(ia):
        na, nr = ta["normal"][ia], tr["normal"][ir]
        nrm = np.minimum(np.abs(na - nr).max(1), np.abs(na + nr).max(1))
        moved = (np.abs(ta["centre"][ia] - tr["centre"][ir]).max(1) > PLANE_CENTRE_M) | (
            nrm > PLANE_NORMAL)
        moved |= ~np.isfinite(na).all(1) | ~np.isfinite(ta["centre"][ia]).all(1)
        flips = float(moved.mean())
    return dict(slots=slots, mom=mom, flips=flips)


def state_gaps(a: Filter, r: Filter) -> Dict[str, float]:
    d = lambda x, y: float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
    return dict(vel=d(a.x[VEL], r.x[VEL]), rot=d(a.R, r.R),
                cov=d(a.P, r.P) / max(float(np.abs(r.P).max()), 1e-30),
                state=max(d(a.R, r.R), d(a.x, r.x), d(a.P, r.P)))


class Reference:
    """The reference's inputs for one run: its packets, its first frame
    and the base noise, worked out once from the raw data.  ``control``
    computes everything one precision below (reference/arith.py)."""

    def __init__(self, settings: dict, traffic: dict, sim_data, control: bool = False):
        self.ar = Arith(control)
        self.cfg = rfilter.make_cfg(settings)
        self.traffic = traffic
        events = sim_data.kin if self.cfg.kin else sim_data.imu
        self.pk = rinputs.packets(settings, sim_data.scans, events)
        f, vm, g_an = rfilter.init(self.ar, self.cfg, self.pk[0], sim_data.scans[0])
        self.start = (f, vm)
        self.base = rinputs.base_noise(settings, g_an)

    def run(self, seed: int, sample, i: int, before: dict) -> Seen:
        """Replica ``sample.replicas[i]`` of a sampled call, from the fleet's
        state and map ``before`` it."""
        from .fleet import trial_seed

        ar, chunk = self.ar, int(self.traffic["scans_per_call"])
        factors = rinputs.jitter(int(self.traffic["replicas"]), float(self.traffic["noise_scale"]),
                                 trial_seed(seed, sample.trial))
        noise = rinputs.replica_noise(self.base, float(factors[sample.replicas[i]]))
        f, vm = program_filter(before, ar), program_map(before, self.cfg, ar)
        pos0, nms = None, []
        for pkt in self.pk[1 + sample.call * chunk: 1 + (sample.call + 1) * chunk]:
            st = rfilter.step(ar, self.cfg, f, vm, pkt, noise)
            f = st.f
            pos0 = st.pos if pos0 is None else pos0
            nms.append(st.n_matched)
        return Seen(self.start if sample.call == 0 else None, (f, vm), pos0, nms)


def seen_program(ref: Reference, window, sample, i: int) -> Seen:
    """What the fleet gave for replica ``sample.replicas[i]`` of a sampled
    call."""
    ar = Arith()
    before = window.snapshots[(sample.tag, sample.call, "before")][i]
    after = window.snapshots[(sample.tag, sample.call, "after")][i]
    start = ((program_filter(before, ar), program_map(before, ref.cfg, ar))
             if sample.call == 0 else None)
    pos, nm = window.readback[(sample.tag, sample.call)]
    r = sample.replicas[i]
    return Seen(start, (program_filter(after, ar), program_map(after, ref.cfg, ar)),
                np.asarray(pos[r, 0], np.float64), [int(v) for v in nm[r]])


def numbers(pairs) -> Dict[str, float]:
    """NUMBERS over (seen, reference's) pairs."""
    nums = dict.fromkeys(NUMBERS, 0.0)

    def put(k, v):
        nums[k] = _worst(nums[k], float(v))

    for got, want in pairs:
        if got.start is not None:
            put("init_state_gap", state_gaps(got.start[0], want.start[0])["state"])
            m = map_gaps(got.start[1], want.start[1])
            put("init_map_slots", m["slots"])
            put("init_mom_gap_rel", m["mom"])
            put("init_plane_flips", m["flips"])
        st = state_gaps(got.after[0], want.after[0])
        m = map_gaps(got.after[1], want.after[1])
        put("pos_gap_m", np.abs(np.asarray(got.pos0, np.float64) - want.pos0).max())
        put("vel_gap_mps", st["vel"])
        put("rot_gap", st["rot"])
        put("cov_gap_rel", st["cov"])
        a, b = got.n_matched[0], want.n_matched[0]
        put("match_gap_rel", abs(a - b) / max(b, 1))
        put("map_slots", m["slots"])
        put("map_mom_gap_rel", m["mom"])
        put("plane_flips", m["flips"])
    return nums


def follow(ref: Reference, seed: int, window, samples) -> list:
    """The reference over every sampled replica: [(sample, i, Seen)]."""
    return [(s, i, ref.run(seed, s, i, window.snapshots[(s.tag, s.call, "before")][i]))
            for s in samples for i in range(len(s.replicas))]


def compare(settings: dict, traffic: dict, sim_data, seed: int, window, samples) -> Dict[str, float]:
    """The numbers of NUMBERS for the window's sampled calls."""
    ref = Reference(settings, traffic, sim_data)
    return numbers((seen_program(ref, window, s, i), want)
                   for s, i, want in follow(ref, seed, window, samples))


def verdict(nums: Dict[str, float], limits: Dict[str, float], window) -> tuple:
    """(correct, [(name, value, limit)] for the numbers the cell compares):
    each at or under its limit, every replica-scan's pose finite."""
    rows = [(k, float(nums[k]), float(limits[k])) for k in NUMBERS if k in limits]
    ok = bool(rows) and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and window.non_finite == 0, rows
