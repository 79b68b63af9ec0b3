"""The voxel map as a dictionary: (level, kx, ky, kz) -> one voxel.

A voxel of level l has the side ``voxel_size / 2^l`` and keeps, relative
to its own centre, the moments of the points it took: their count n, the
count since its last fit, sum p, sum p p^T, and the moments of their
covariances V (sum V, sum V (x) p, sum V (x) p p^T), from which its plane
and the plane's 6x6 covariance follow exactly (the upstream's init_plane,
voxel_map.cc:42-117).  A voxel stops taking points at ``max_points_num``;
it is refitted once it holds more than its level's ``layer_init_num``
points and is new or has taken more than ``UPDATE_SIZE`` points since its
last fit.

The map has no capacity: every new voxel gets a place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .arith import Arith

UPDATE_SIZE = 5       # points a fitted voxel takes before it is refitted
ALPHA_EPS = 1e-7      # the smallest |n (lambda_min - lambda_k)| a fit divides by


class MapCfg:
    """The map's settings from the run's flat YAML keys."""

    def __init__(self, s: dict):
        self.levels = int(s["max_layer"]) + 1
        self.voxel_size = float(s["voxel_size"])
        self.sizes = [self.voxel_size / 2.0 ** l for l in range(self.levels)]
        self.planar = float(s["min_eigen_value"])
        self.sigma_num = float(s["sigma_num"])
        self.max_points = int(s["max_points_num"])
        self.init_num = [int(v) for v in s["layer_init_num"][: self.levels]]
        self.radius_k = 3.0
        self.row_cap = int(s.get("tpu_map_insert_row_cap", 0))
        self.refit_budget = int(s.get("tpu_map_refit_budget", 2048))


FIELDS = {  # name: shape of one voxel's entry
    "n": (), "new": (), "init": (), "plane": (),
    "m1": (3,), "m2": (3, 3), "s0": (3, 3), "s1": (3, 3, 3), "s2": (3, 3, 3, 3),
    "centre": (3,), "normal": (3,), "evals": (3,), "radius": (), "pv": (6, 6),
}


class VoxelMap:
    """Voxels in arrays of rows, found by ``index``."""

    def __init__(self, cfg: MapCfg, ar: Arith, rows: int = 1024):
        self.cfg, self.ar = cfg, ar
        self.index: Dict[Tuple[int, int, int, int], int] = {}
        self.keys = np.zeros((rows, 4), dtype=np.int64)
        self.t = {k: np.zeros((rows,) + s, dtype=ar.dt) for k, s in FIELDS.items()}

    def __len__(self) -> int:
        return len(self.index)

    def _grow(self, need: int) -> None:
        cap = len(self.keys)
        if need <= cap:
            return
        cap = max(need, 2 * cap)
        self.keys = np.concatenate([self.keys, np.zeros((cap - len(self.keys), 4), np.int64)])
        self.t = {k: np.concatenate([v, np.zeros((cap - len(v),) + v.shape[1:], v.dtype)])
                  for k, v in self.t.items()}

    def find(self, level: np.ndarray, keys: np.ndarray) -> np.ndarray:
        """Row of each (level, key), -1 where the map has no such voxel."""
        idx = self.index
        return np.fromiter((idx.get((int(l), int(a), int(b), int(c)), -1)
                            for l, (a, b, c) in zip(np.broadcast_to(level, len(keys)), keys)),
                           dtype=np.int64, count=len(keys))

    def add_voxels(self, lk: np.ndarray) -> np.ndarray:
        """Rows of the voxels (level, key) [M, 4], new ones made empty."""
        out = np.empty(len(lk), dtype=np.int64)
        for i, row in enumerate(lk):
            key = tuple(int(v) for v in row)
            j = self.index.get(key)
            if j is None:
                j = len(self.index)
                self._grow(j + 1)
                self.index[key] = j
                self.keys[j] = row
            out[i] = j
        return out

    def centre_of(self, level: np.ndarray, keys: np.ndarray) -> np.ndarray:
        size = np.asarray(self.cfg.sizes)[level]
        return (keys + 0.5) * size[..., None]

    def insert(self, level: np.ndarray, keys: np.ndarray, p_w: np.ndarray, var: np.ndarray) -> int:
        """Add points (world p_w [M, 3] with covariance var [M, 3, 3]) to the
        voxels (level [M], key [M, 3]) and refit; a voxel full before the
        call takes none.  Returns how many voxels wanted a refit beyond the
        refit budget (all of them are refitted here)."""
        ar = self.ar
        if not len(keys):
            return 0
        rows = self.add_voxels(np.concatenate([level[:, None], keys], axis=1))
        t = self.t
        take = t["n"][rows] < self.cfg.max_points
        rows, level, keys = rows[take], level[take], keys[take]
        p = ar.f(p_w[take]) - ar.f(self.centre_of(level, keys))
        v = ar.f(var[take])
        pp = ar.ein("ni,nj->nij", p, p)
        uniq, inv = np.unique(rows, return_inverse=True)
        for name, vals in (("n", np.ones(len(rows), ar.dt)), ("new", np.ones(len(rows), ar.dt)),
                           ("m1", p), ("m2", pp), ("s0", v), ("s1", ar.ein("nij,na->nija", v, p)),
                           ("s2", ar.ein("nij,nab->nijab", v, pp))):
            acc = np.zeros((len(uniq),) + vals.shape[1:], dtype=ar.dt)
            np.add.at(acc, inv, vals)
            t[name][uniq] += acc
        lv = self.keys[uniq, 0]
        due = (t["n"][uniq] > np.asarray(self.cfg.init_num)[lv]) & (
            (t["init"][uniq] < 0.5) | (t["new"][uniq] > UPDATE_SIZE))
        self.refit(uniq[due])
        return max(0, int(due.sum()) - self.cfg.refit_budget)

    def refit(self, rows: np.ndarray) -> None:
        """The plane of each voxel from its moments: the centre, the normal
        (the covariance's least eigenvector), the eigenvalues, the radius
        sqrt(largest eigenvalue), and the covariance of (normal, centre)
        that the points' covariances give, summed over the points of
        d(normal, centre)/dp V d(normal, centre)/dp^T."""
        if not len(rows):
            return
        ar, t = self.ar, self.t
        n = np.maximum(t["n"][rows], 1.0)
        c = t["m1"][rows] / n[:, None]
        C = t["m2"][rows] / n[:, None, None] - ar.ein("ni,nj->nij", c, c)
        lam, E = np.linalg.eigh(C)
        lam, E = lam.astype(ar.dt), E.astype(ar.dt)
        e0 = E[:, :, 0]
        plane = lam[:, 0] < self.cfg.planar
        # Moments about the centre: Vp[i,j,a] = sum V_ij (p - c)_a and
        # Vpp[i,j,a,b] = sum V_ij (p - c)_a (p - c)_b.
        s0, s1, s2 = t["s0"][rows], t["s1"][rows], t["s2"][rows]
        Vp = s1 - ar.ein("nij,na->nija", s0, c)
        Vpp = (s2 - ar.ein("nija,nb->nijab", s1, c) - ar.ein("nijb,na->nijab", s1, c)
               + ar.ein("nij,na,nb->nijab", s0, c, c))
        # d normal / d p_i = sum_k e_k a_k (p_i - c)^T B_k, k the two other
        # eigenvectors, a_k = 1 / (n (lambda_0 - lambda_k)),
        # B_k = e_k e_0^T + e_0 e_k^T.
        a, B = [], []
        for k in (1, 2):
            d = n * (lam[:, 0] - lam[:, k])
            d = np.where(np.abs(d) < ALPHA_EPS, -ALPHA_EPS, d)
            a.append(1.0 / d)
            ek = E[:, :, k]
            B.append(ar.ein("ni,nj->nij", ek, e0) + ar.ein("ni,nj->nij", e0, ek))
        pv = np.zeros((len(rows), 6, 6), dtype=ar.dt)
        for i in range(2):
            ei = E[:, :, i + 1]
            # sum over points of (p - c)^T B_i V  -> [n, 3]
            u = ar.ein("nab,nbca->nc", B[i], Vp)
            pv[:, 0:3, 3:6] += (a[i] / n)[:, None, None] * ar.ein("ni,nj->nij", ei, u)
            for j in range(2):
                ej = E[:, :, j + 1]
                cij = ar.ein("nab,ncd,nbcad->n", B[i], B[j], Vpp)
                pv[:, 0:3, 0:3] += (a[i] * a[j] * cij)[:, None, None] * ar.ein("ni,nj->nij", ei, ej)
        pv[:, 3:6, 0:3] = np.swapaxes(pv[:, 0:3, 3:6], 1, 2)
        pv[:, 3:6, 3:6] = s0 / (n * n)[:, None, None]
        pv[~plane] = 0.0
        t["centre"][rows] = c
        t["normal"][rows] = e0
        t["evals"][rows] = lam
        t["radius"][rows] = np.sqrt(np.maximum(lam[:, 2], 0.0))
        t["pv"][rows] = pv
        t["plane"][rows] = plane
        t["init"][rows] = 1.0
        t["new"][rows] = 0.0
