"""Batched PCD map export.

The port's own copy of ``legkilo_tpu/io/pcd.py`` (numpy only); it takes the
runner's host-side ``ScanResult.cloud_world`` and ``intensity``.
Parity: PcdSaver (legkilo/src/common/pcd_saver.hpp) — buffer
``frames_per_file`` frames of world-frame cloud, voxel-downsample, write a
binary PCD file per batch into a timestamped session directory.  Per-point
intensity (PointXYZINormal's carried channel, lidar_processing.cc:46) is
written as a 4th field when provided.  The reference uses a dedicated
writer thread; here writes happen on a ThreadPoolExecutor so the replay
loop never blocks on disk.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from .dataset import voxel_downsample


def write_pcd(
    path: str, points: np.ndarray, intensity: Optional[np.ndarray] = None
) -> None:
    """Write an xyz[+intensity] binary PCD v0.7 file."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = len(pts)
    if intensity is not None:
        fields, data = "x y z intensity", np.concatenate(
            [pts, np.asarray(intensity, np.float32).reshape(n, 1)], axis=1
        )
    else:
        fields, data = "x y z", pts
    ncol = data.shape[1]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE{' 4' * ncol}\n"
        f"TYPE{' F' * ncol}\n"
        f"COUNT{' 1' * ncol}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        "DATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())


def read_pcd(path: str) -> np.ndarray:
    """Read a float32 (binary or ascii) PCD file back into [N, n_fields]
    (xyz in the first 3 columns; intensity, when present, in column 3)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        n = int(header["POINTS"])
        ncol = len(header.get("FIELDS", "x y z").split())
        if header["DATA"] == "binary":
            raw = f.read(n * 4 * ncol)
            return np.frombuffer(raw, dtype=np.float32).reshape(n, ncol).copy()
        pts = np.loadtxt(f, max_rows=n, dtype=np.float32)
        return pts.reshape(n, ncol)


class PcdSaver:
    """Accumulate frames, downsample, write asynchronously."""

    def __init__(
        self,
        directory: str = "result/PCD",
        frames_per_file: int = 100,
        leaf_size: float = 0.1,
    ):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.directory = os.path.join(directory, stamp)
        os.makedirs(self.directory, exist_ok=True)
        self.frames_per_file = frames_per_file
        self.leaf_size = leaf_size
        self._buffer: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        self._file_idx = 0
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []

    def save(
        self,
        cloud_world: np.ndarray,
        mask: Optional[np.ndarray] = None,
        intensity: Optional[np.ndarray] = None,
    ) -> None:
        pts = np.asarray(cloud_world, dtype=np.float32).reshape(-1, 3)
        inten = (
            np.asarray(intensity, dtype=np.float32).reshape(-1)
            if intensity is not None else None
        )
        if mask is not None:
            m = np.asarray(mask).reshape(-1)
            pts = pts[m]
            inten = inten[m] if inten is not None else None
        good = np.isfinite(pts).all(axis=1) & (np.abs(pts) < 1e6).all(axis=1)
        pts = pts[good]
        inten = inten[good] if inten is not None else None
        self._buffer.append((pts, inten))
        if len(self._buffer) >= self.frames_per_file:
            self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        merged = np.concatenate([b[0] for b in self._buffer])
        # Intensity is kept only if every buffered frame carried it.
        if all(b[1] is not None for b in self._buffer):
            merged_i = np.concatenate([b[1] for b in self._buffer])
        else:
            merged_i = None
        self._buffer = []
        idx = self._file_idx
        self._file_idx += 1
        leaf = self.leaf_size

        def job():
            pts, _, inten = voxel_downsample(
                merged, np.zeros(len(merged), dtype=np.float32), leaf, merged_i
            )
            write_pcd(
                os.path.join(self.directory, f"map_{idx:04d}.pcd"), pts, inten
            )

        self._pending.append(self._pool.submit(job))

    def close(self) -> None:
        self._flush()
        for fut in self._pending:
            fut.result()
        self._pool.shutdown()
