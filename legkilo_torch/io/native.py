"""ctypes bindings for the native scan-preprocessing library.

The port's own copy of ``legkilo_tpu/io/native.py``.  native/scanprep.cc
implements the hot host-side decode path (decimation, blind filter, 2 ms
quantization, centroid voxel downsample, bucket packing) in C++, mirroring
the reference's native preprocessing (lidar_processing.cc).  The port
loads the committed ``native/libscanprep.so`` from the repository root and
never builds it.  Where it cannot be loaded, ``process_scan`` and
``decimate_blind`` return None, a warning is logged once, and the caller
takes the numpy path of io/dataset.py.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

LIB_PATH = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libscanprep.so"))


@functools.cache
def _lib() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as exc:
        log.warning("native scan prep unavailable (%s); packets are built with numpy", exc)
        return None
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.scanprep_process.restype = ctypes.c_int
    lib.scanprep_process.argtypes = [
        f32p, f32p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        f32p, u8p, f32p, u8p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, i32p,
    ]
    lib.scanprep_decimate_blind.restype = ctypes.c_int
    lib.scanprep_decimate_blind.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, f32p, ctypes.c_int,
    ]
    return lib


def available() -> bool:
    return _lib() is not None


def process_scan(
    points: np.ndarray,       # [N, 3] float32
    time_offset: np.ndarray,  # [N] float32
    filter_num: int,
    blind: float,
    leaf: float,
    requantize: bool,
    nb: int,
    pmax: int,
    intensity: Optional[np.ndarray] = None,  # [N] float32
) -> Optional[Tuple[
    np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int,
    Optional[np.ndarray],
]]:
    """Native decimate/downsample/bucketize.  Returns
    (bucket_time, bucket_mask, points, point_mask, n_down, dropped,
    intensity_or_None) or None if the library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    toff = np.ascontiguousarray(time_offset, dtype=np.float32)
    if len(toff) != len(pts):
        raise ValueError(f"{len(pts)} points but {len(toff)} time offsets")
    bucket_time = np.zeros(nb, dtype=np.float32)
    bucket_mask = np.zeros(nb, dtype=np.uint8)
    out_pts = np.zeros((nb, pmax, 3), dtype=np.float32)
    point_mask = np.zeros((nb, pmax), dtype=np.uint8)
    counts = np.zeros(3, dtype=np.int32)
    if intensity is not None:
        inten = np.ascontiguousarray(intensity, dtype=np.float32)
        if len(inten) != len(pts):
            raise ValueError(f"{len(pts)} points but {len(inten)} intensities")
        out_inten = np.zeros((nb, pmax), dtype=np.float32)
        inten_p = inten.ctypes.data_as(ctypes.c_void_p)
        out_inten_p = out_inten.ctypes.data_as(ctypes.c_void_p)
    else:
        inten = out_inten = None
        inten_p = out_inten_p = None
    lib.scanprep_process(
        pts, toff, inten_p, len(pts),
        int(filter_num), float(blind), float(leaf), int(requantize),
        bucket_time, bucket_mask, out_pts, point_mask, out_inten_p,
        int(nb), int(pmax), counts,
    )
    return (
        bucket_time, bucket_mask.astype(bool), out_pts,
        point_mask.astype(bool), int(counts[0]), int(counts[1]), out_inten,
    )


def decimate_blind(
    points: np.ndarray, filter_num: int, blind: float
) -> Optional[np.ndarray]:
    """Native 1/filter_num decimation and blind-radius removal; None if
    the library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    out = np.zeros_like(pts)
    m = lib.scanprep_decimate_blind(pts, len(pts), int(filter_num), float(blind), out, len(pts))
    return out[:m].copy()
