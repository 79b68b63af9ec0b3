"""Vendor LiDAR decode: PointCloud2 -> RawScan (body points + point times).

The port's own copy of ``legkilo_tpu/models/lidar.py`` (numpy only).
Capability parity with LidarProcessing
(legkilo/src/preprocess/lidar_processing.{h,cc}):

  * velodyne: per-point relative float32 ``time`` field, scan begin/end =
    header stamp + first/last offsets (handles end-stamped legkilo bags,
    where offsets are negative) — lidar_processing.cc:25-52
  * ouster:   per-point uint32 ``t`` (ns by time_scale), same stamping —
    lidar_processing.cc:54-80
  * hesai:    per-point absolute float64 ``timestamp``;
    scan begin/end come from the points themselves — lidar_processing.cc:82-108

Decimation, blind filtering and 2 ms quantization live in io/dataset.py
(shared with the simulator path); this module only decodes.
"""

from __future__ import annotations

import numpy as np

from ..config import LidarConfig
from ..io.dataset import RawScan
from ..io.rosbag import PointCloud2Msg

VELODYNE, OUSTER, HESAI = 1, 2, 3


def decode(msg: PointCloud2Msg, cfg: LidarConfig) -> RawScan:
    if cfg.lidar_type == VELODYNE:
        return _decode_relative(msg, cfg, time_field="time")
    if cfg.lidar_type == OUSTER:
        return _decode_relative(msg, cfg, time_field="t")
    if cfg.lidar_type == HESAI:
        return _decode_hesai(msg, cfg)
    raise ValueError(f"Lidar type {cfg.lidar_type} is not currently available")


def _xyz(arr: np.ndarray) -> np.ndarray:
    return np.stack(
        [arr["x"].astype(np.float32), arr["y"].astype(np.float32),
         arr["z"].astype(np.float32)], axis=-1,
    )


def _decode_relative(msg: PointCloud2Msg, cfg: LidarConfig, time_field: str) -> RawScan:
    arr = msg.as_struct_array()
    t_rel = arr[time_field].astype(np.float64) * cfg.time_scale
    first, last = float(t_rel[0]), float(t_rel[-1])
    begin = msg.stamp + first
    end = msg.stamp + last
    return RawScan(
        begin_time=begin,
        end_time=end,
        points=_xyz(arr),
        time_offset=(t_rel - first).astype(np.float32),
        intensity=arr["intensity"].astype(np.float32) if "intensity" in arr.dtype.names else None,
    )


def _decode_hesai(msg: PointCloud2Msg, cfg: LidarConfig) -> RawScan:
    arr = msg.as_struct_array()
    t_abs = arr["timestamp"].astype(np.float64) * cfg.time_scale
    begin, end = float(t_abs[0]), float(t_abs[-1])
    return RawScan(
        begin_time=begin,
        end_time=end,
        points=_xyz(arr),
        time_offset=(t_abs - begin).astype(np.float32),
        intensity=arr["intensity"].astype(np.float32) if "intensity" in arr.dtype.names else None,
    )
