"""Plane-map visualization export.

The port's own copy of ``legkilo_tpu/io/plane_export.py``: it reads the
map back from the card once and walks it on the host.  Parity with the
reference's rviz MarkerArray plane publishing
(pubVoxelMap/GetUpdatePlane/pubSinglePlane/mapJet,
legkilo/src/core/slam/voxel_map.cc:429-550): each planar
voxel is rendered as an ellipse disk spanned by the mid/max eigenvectors
(axes 3*sqrt(eig)), colored by a jet colormap over the plane-covariance
trace.  Without ROS, the export target is a PLY mesh (viewable in
CloudCompare/MeshLab) plus a JSON sidecar of the raw plane parameters.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from ..core.voxel_map import MapConfig, VoxelMap, level_size


def _host(vm: VoxelMap) -> VoxelMap:
    """The map's tables as float32/int32 numpy arrays: the ``plane`` and
    ``moms`` tables may be stored narrow (``storage_dtype``) on the card."""
    return VoxelMap(*(t.detach().cpu().float().numpy() if t.is_floating_point()
                      else t.detach().cpu().numpy() for t in vm))


def extract_planes(vm: VoxelMap, cfg: MapConfig, max_level: Optional[int] = None):
    """Pull all fitted planes out of the device map (GetUpdatePlane analog).

    Honors the octree search order: planes at level l are only reported when
    no ancestor is itself a plane (voxel_map.cc:461-475).
    Returns a list of dicts.
    """
    planes = []
    max_level = cfg.levels - 1 if max_level is None else max_level
    # Tables are stored flat [L*C, ...]; view per level for the walk.
    L, C = cfg.levels, cfg.capacity
    vm = _host(vm)
    occ = vm.occ.reshape(L, C)
    is_plane = vm.is_plane().reshape(L, C)
    keys = vm.key.reshape(L, C, 3)
    center_rel = vm.center_rel().reshape(L, C, 3)
    normal = vm.normal().reshape(L, C, 3)
    evals = vm.evals().reshape(L, C, 3)
    pvar = vm.plane_var().reshape(L, C, 6, 6)
    # Ancestor-planar lookup per level.
    planar_keys = [
        {tuple(k) for k, o, p in zip(keys[l], occ[l], is_plane[l]) if o and p}
        for l in range(cfg.levels)
    ]
    for lvl in range(min(max_level + 1, cfg.levels)):
        size = level_size(cfg, lvl)
        for s in np.nonzero(occ[lvl] & is_plane[lvl])[0]:
            key = keys[lvl][s]
            shadowed = False
            k = key
            for a in range(lvl - 1, -1, -1):
                k = k >> 1
                if tuple(k) in planar_keys[a]:
                    shadowed = True
                    break
            if shadowed:
                continue
            vc = (key + 0.5) * size
            planes.append(
                dict(
                    level=lvl,
                    center=(vc + center_rel[lvl][s]).tolist(),
                    normal=normal[lvl][s].tolist(),
                    evals=evals[lvl][s].tolist(),
                    var_trace=float(np.trace(pvar[lvl][s][0:3, 0:3])),
                )
            )
    return planes


def map_jet(v: float, vmin: float = 0.0, vmax: float = 1.0) -> Tuple[int, int, int]:
    """Jet colormap (mapJet, voxel_map.cc:515-550)."""
    v = min(max(v, vmin), vmax)
    dr = dg = db = 0.0
    if v < 0.1242:
        db = 0.504 + ((1.0 - 0.504) / 0.1242) * v
    elif v < 0.3747:
        db = 1.0
        dg = (v - 0.1242) / (0.3747 - 0.1242)
    elif v < 0.6253:
        db = (0.6253 - v) / (0.6253 - 0.3747)
        dg = 1.0
        dr = (v - 0.3747) / (0.6253 - 0.3747)
    elif v < 0.8758:
        dr = 1.0
        dg = (0.8758 - v) / (0.8758 - 0.6253)
    else:
        dr = 1.0 - (v - 0.8758) * ((1.0 - 0.504) / (1.0 - 0.8758))
    return int(255 * dr), int(255 * dg), int(255 * db)


def _basis_from_normal(n: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    return u, np.cross(n, u)


def write_ply(path: str, planes: List[dict], segments: int = 12,
              max_trace: float = 0.25, pow_num: float = 0.2) -> None:
    """Write plane disks as a colored triangle mesh (pubSinglePlane analog:
    radii 3*sqrt(mid/max eigenvalues), jet color over normalized
    plane-covariance trace; voxel_map.cc:440-455, 477-501)."""
    verts: List[Tuple] = []
    faces: List[Tuple[int, int, int]] = []
    for pl in planes:
        c = np.asarray(pl["center"])
        n = np.asarray(pl["normal"])
        ev = pl["evals"]
        r1 = 3.0 * np.sqrt(max(ev[2], 0.0))
        r2 = 3.0 * np.sqrt(max(ev[1], 0.0))
        trace = min(pl["var_trace"], max_trace) / max_trace
        rgb = map_jet(trace ** pow_num)
        u, v = _basis_from_normal(n)
        base = len(verts)
        verts.append((*c, *rgb))
        for s in range(segments):
            ang = 2 * np.pi * s / segments
            p = c + r1 * np.cos(ang) * u + r2 * np.sin(ang) * v
            verts.append((*p, *rgb))
        for s in range(segments):
            faces.append((base, base + 1 + s, base + 1 + (s + 1) % segments))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for x, y, z, r, g, b in verts:
            f.write(f"{x:.4f} {y:.4f} {z:.4f} {r} {g} {b}\n")
        for a, b2, c2 in faces:
            f.write(f"3 {a} {b2} {c2}\n")


def export_plane_map(vm: VoxelMap, cfg: MapConfig, ply_path: str,
                     json_path: Optional[str] = None) -> int:
    """Full export: returns the number of planes written."""
    planes = extract_planes(vm, cfg)
    write_ply(ply_path, planes)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(planes, f)
    return len(planes)
