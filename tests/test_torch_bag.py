"""``run`` and ``eval`` and the host modules under them vs the JAX package, on the CPU.

Each module the port copied for the bag path (io/rosbag, models/lidar,
models/unitree, io/tum, utils, io/native, io/pcd, io/plane_export) is held
against its JAX twin on the same inputs, exactly unless a test says
otherwise.  End to end: ~2 s sim bags (Imu and HighState), written by
chip_smoke.py's bag writer, decode to the same packets in both packages,
and ``python -m legkilo_torch run --device cpu`` replays them within the
JAX package's own ATE bounds (tests/test_bag_e2e.py) and, on the Imu bag,
within 4x the JAX package's own spread of its ``run``.
"""

import bz2
import io
import json
import logging
import pathlib
import struct
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax

import test_rosbag as baggen
from legkilo_tpu import cli as j_cli
from legkilo_tpu import config as j_config
from legkilo_tpu.core import filter as j_filter
from legkilo_tpu.core import voxel_map as j_vmap
from legkilo_tpu.io import dataset as j_ds
from legkilo_tpu.io import native as j_native
from legkilo_tpu.io import pcd as j_pcd
from legkilo_tpu.io import plane_export as j_pe
from legkilo_tpu.io import rosbag as j_rb
from legkilo_tpu.io import tum as j_tum
from legkilo_tpu.models import lidar as j_lidar
from legkilo_tpu.models import unitree as j_ut

import chip_smoke as cs
from legkilo_torch import cli as t_cli
from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch.core import voxel_map as t_vmap
from legkilo_torch.io import dataset as t_ds
from legkilo_torch.io import native as t_native
from legkilo_torch.io import pcd as t_pcd
from legkilo_torch.io import plane_export as t_pe
from legkilo_torch.io import rosbag as t_rb
from legkilo_torch.io import tum as t_tum
from legkilo_torch.models import lidar as t_lidar
from legkilo_torch.models import unitree as t_ut
from legkilo_torch.utils import logging as t_logging
from legkilo_torch.utils import profiling as t_prof
from legkilo_torch.utils import timing as t_timing
from torch_util import BAG_RUN_YAML, bag_ate, one_thread, write_bag_run  # noqa: F401


# -- rosbag ------------------------------------------------------------------

def _messages(rng):
    pts = rng.uniform(-5, 5, size=(40, 3)).astype(np.float32)
    times = np.linspace(0, 0.1, 40).astype(np.float32)
    acc, gyr = rng.normal(size=3), rng.normal(size=3)
    q, dq = rng.normal(size=20), rng.normal(size=20)
    ff = np.array([250, 100, 240, 90], dtype=np.int16)
    return [
        ("/imu_raw", "sensor_msgs/Imu", 10.0, baggen.serialize_imu(10.0, acc, gyr)),
        ("/points_raw", "sensor_msgs/PointCloud2", 10.05,
         baggen.serialize_pointcloud2(10.05, pts, times)),
        ("/high_state", "unitree_legged_msgs/HighState", 10.1,
         baggen.serialize_high_state(10.1, acc, gyr, q, dq, ff)),
        ("/imu_raw", "sensor_msgs/Imu", 10.2, baggen.serialize_imu(10.2, gyr, acc)),
    ]


def _with_chunk_compression(src, dst, compression):
    """A copy of a bag of one chunk with that chunk compressed: bz2, or
    only relabelled for any other name."""
    raw = open(src, "rb").read()
    off = len(j_rb.BagReader.MAGIC)
    (hlen,) = struct.unpack_from("<I", raw, off)
    off += 4 + hlen
    (dlen,) = struct.unpack_from("<I", raw, off)
    off += 4 + dlen
    head = raw[:off]
    (hlen,) = struct.unpack_from("<I", raw, off)
    (dlen,) = struct.unpack_from("<I", raw, off + 4 + hlen)
    chunk = raw[off + 8 + hlen: off + 8 + hlen + dlen]
    data = bz2.compress(chunk) if compression == b"bz2" else chunk
    rec = baggen._record({b"op": b"\x05", b"compression": compression,
                          b"size": struct.pack("<I", len(chunk))}, data)
    with open(dst, "wb") as f:
        f.write(head + rec)


def _read(mod, path, topics=None):
    with mod.BagReader(path) as r:
        return list(r.messages(topics))


def _same_messages(tm, jm):
    assert [(m.topic, m.msg_type, m.time, m.raw) for m in tm] == \
        [(m.topic, m.msg_type, m.time, m.raw) for m in jm]


@pytest.mark.parametrize("compression", [b"none", b"bz2"])
def test_rosbag_reader_and_parsers_match_jax(tmp_path, rng, compression):
    path = str(tmp_path / "a.bag")
    baggen.write_bag(path, _messages(rng))
    if compression != b"none":
        _with_chunk_compression(path, path + ".z", compression)
        path += ".z"
    tm, jm = _read(t_rb, path), _read(j_rb, path)
    assert len(tm) == 4
    _same_messages(tm, jm)
    for t, j in zip(tm, jm):
        if t.msg_type == "sensor_msgs/Imu":
            a, b = t_rb.parse_imu(t.raw), j_rb.parse_imu(j.raw)
            assert a.stamp == b.stamp
            for f in ("orientation", "angular_velocity", "linear_acceleration"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
        elif t.msg_type == "sensor_msgs/PointCloud2":
            a, b = t_rb.parse_pointcloud2(t.raw), j_rb.parse_pointcloud2(j.raw)
            assert (a.stamp, a.height, a.width, a.fields, a.point_step, a.data) == \
                (b.stamp, b.height, b.width, b.fields, b.point_step, b.data)
            sa, sb = a.as_struct_array(), b.as_struct_array()
            assert sa.dtype == sb.dtype and np.array_equal(sa, sb)
        else:
            a, b = t_rb.parse_high_state(t.raw), j_rb.parse_high_state(j.raw)
            assert a.stamp == b.stamp
            for f in ("accelerometer", "gyroscope", "motor_q", "motor_dq", "foot_force"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_rosbag_topic_filter_matches_jax(tmp_path, rng):
    path = str(tmp_path / "a.bag")
    baggen.write_bag(path, _messages(rng))
    for topics in (["/imu_raw"], ["/points_raw", "/high_state"], ["/none"]):
        tm = _read(t_rb, path, topics)
        _same_messages(tm, _read(j_rb, path, topics))
        assert {m.topic for m in tm} <= set(topics)
    assert len(_read(t_rb, path, ["/imu_raw"])) == 2


def test_rosbag_unknown_compression_raises(tmp_path, rng, monkeypatch):
    """An lz4 chunk needs the lz4 module (ImportError without it) and any
    other compression raises ValueError: no chunk is skipped silently."""
    path = str(tmp_path / "a.bag")
    baggen.write_bag(path, _messages(rng))
    _with_chunk_compression(path, path + ".zst", b"zstd")
    for mod in (t_rb, j_rb):
        with pytest.raises(ValueError, match="zstd"):
            _read(mod, path + ".zst")
    _with_chunk_compression(path, path + ".lz4", b"lz4")
    monkeypatch.setitem(sys.modules, "lz4", None)  # as on a host without lz4
    for mod in (t_rb, j_rb):
        with pytest.raises(ImportError):
            _read(mod, path + ".lz4")


def test_bag_writer_matches_the_test_writer(tmp_path, rng):
    """chip_smoke.py's writer (the bag phases' input, the end-to-end tests'
    bags) writes the bytes tests/test_rosbag.py's writer writes."""
    msgs = _messages(rng)
    cs.write_bag(str(tmp_path / "a.bag"), msgs)
    baggen.write_bag(str(tmp_path / "b.bag"), msgs)
    assert (tmp_path / "a.bag").read_bytes() == (tmp_path / "b.bag").read_bytes()
    acc, gyr, q, dq = rng.normal(size=3), rng.normal(size=3), rng.normal(size=20), rng.normal(size=20)
    ff = np.array([400, 0, 10, 250])
    assert cs.serialize_imu(3.25, acc, gyr) == baggen.serialize_imu(3.25, acc, gyr)
    assert cs.serialize_high_state(3.25, acc, gyr, q, dq, ff) == \
        baggen.serialize_high_state(3.25, acc, gyr, q, dq, ff)
    pts = rng.uniform(-5, 5, size=(30, 3)).astype(np.float32)
    times = np.linspace(0, 0.1, 30).astype(np.float32)
    inten = cs.scan_intensity(pts)
    arr = t_rb.parse_pointcloud2(cs.serialize_pointcloud2(3.25, pts, times, inten)).as_struct_array()
    ref = j_rb.parse_pointcloud2(baggen.serialize_pointcloud2(3.25, pts, times)).as_struct_array()
    for f in ("x", "y", "z", "time"):
        assert np.array_equal(arr[f], ref[f]), f
    assert np.array_equal(arr["intensity"], inten)


# -- lidar, unitree ------------------------------------------------------------

def _cloud(mod, rng, lidar_type, n=50):
    pts = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1), ("intensity", 12, 7, 1)]
    if lidar_type == 1:     # velodyne: relative f32 seconds, end-stamped
        tf, tdt, tval = "time", 7, np.linspace(-0.1, 0.0, n).astype(np.float32)
    elif lidar_type == 2:   # ouster: relative u32 nanoseconds
        tf, tdt, tval = "t", 6, np.linspace(0, 9.9e7, n).astype(np.uint32)
    else:                   # hesai: absolute f64 seconds
        tf, tdt, tval = "timestamp", 8, 20.0 + np.linspace(0, 0.1, n)
    fields.append((tf, 16, tdt, 1))
    dtype = np.dtype({"names": ["x", "y", "z", "intensity", tf],
                      "formats": ["<f4"] * 4 + [tval.dtype.newbyteorder("<")],
                      "offsets": [0, 4, 8, 12, 16], "itemsize": 24})
    arr = np.zeros(n, dtype=dtype)
    arr["x"], arr["y"], arr["z"] = pts.T
    arr["intensity"] = rng.uniform(0, 255, n)
    arr[tf] = tval
    return mod.PointCloud2Msg(stamp=20.0, height=1, width=n, fields=fields, point_step=24,
                              data=arr.tobytes())


@pytest.mark.parametrize("lidar_type,time_scale", [(1, 1.0), (2, 1e-9), (3, 1.0)])
def test_lidar_decode_matches_jax(rng, lidar_type, time_scale):
    seed = int(rng.integers(1 << 30))
    t_scan = t_lidar.decode(_cloud(t_rb, np.random.default_rng(seed), lidar_type),
                            t_config.LidarConfig(lidar_type=lidar_type, time_scale=time_scale))
    j_scan = j_lidar.decode(_cloud(j_rb, np.random.default_rng(seed), lidar_type),
                            j_config.LidarConfig(lidar_type=lidar_type, time_scale=time_scale))
    assert (t_scan.begin_time, t_scan.end_time) == (j_scan.begin_time, j_scan.end_time)
    assert t_scan.end_time > t_scan.begin_time
    for f in ("points", "time_offset", "intensity"):
        a, b = getattr(t_scan, f), getattr(j_scan, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_kinematics_processing_matches_jax(rng):
    """A seeded HighState sequence whose foot forces cross both Schmitt
    thresholds (200 and 220): contacts, foot positions and velocities equal."""
    tk, jk = t_ut.Kinematics(t_config.KinematicsConfig()), j_ut.Kinematics(j_config.KinematicsConfig())
    n_on = n_off = 0
    for i in range(60):
        force = rng.choice([0.0, 150.0, 199.0, 201.0, 210.0, 219.0, 221.0, 300.0], size=4)
        kw = dict(stamp=1.0 + 0.002 * i, accelerometer=rng.normal(size=3), gyroscope=rng.normal(size=3),
                  motor_q=rng.normal(scale=0.5, size=20), motor_dq=rng.normal(size=20), foot_force=force)
        before = tk.contacts.in_contact.copy()
        a, b = tk.processing(t_ut.HighState(**kw)), jk.processing(j_ut.HighState(**kw))
        n_on += int((~before & a.contact).sum())
        n_off += int((before & ~a.contact).sum())
        assert a.time == b.time
        for f in ("acc", "gyr", "foot_pos", "foot_vel", "contact"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (i, f)
    assert n_on > 5 and n_off > 5


# -- tum, eval -----------------------------------------------------------------

def _write_tum(path, t, p, q):
    np.savetxt(path, np.concatenate([t[:, None], p, q], axis=1), fmt="%.9f")


def test_tum_read_associate_rpe_and_eval_match_jax(tmp_path, rng, capsys):
    n = 60
    t_gt = np.arange(n) * 0.1
    p_gt = np.cumsum(rng.normal(scale=0.05, size=(n, 3)), axis=0)
    q_gt = rng.normal(size=(n, 4))
    t_est = t_gt + rng.uniform(-0.004, 0.004, n)
    p_est = p_gt + rng.normal(scale=0.01, size=(n, 3))
    q_est = q_gt + rng.normal(scale=0.01, size=(n, 4))
    est, gt = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    _write_tum(est, t_est[5:], p_est[5:], q_est[5:])
    _write_tum(gt, t_gt, p_gt, q_gt)
    for path in (est, gt):
        for a, b in zip(t_tum.read_tum(path), j_tum.read_tum(path)):
            assert np.array_equal(a, b)
    te, pe, qe = t_tum.read_tum(est)
    tg, pg, qg = t_tum.read_tum(gt)
    for max_dt in (0.002, 0.02):
        ia, ib = t_tum.associate(te, tg, max_dt=max_dt)
        ja, jb = j_tum.associate(te, tg, max_dt=max_dt)
        assert np.array_equal(ia, ja) and np.array_equal(ib, jb)
    assert np.array_equal(t_tum.rot_from_quat_xyzw(qe), j_tum.rot_from_quat_xyzw(qe))
    for delta in (1, 3):
        assert t_tum.rpe(pe, pg[5:], qe, qg[5:], delta=delta) == j_tum.rpe(pe, pg[5:], qe, qg[5:], delta=delta)
        assert np.array_equal(t_tum.rpe(pe, pg[5:], delta=delta), j_tum.rpe(pe, pg[5:], delta=delta),
                              equal_nan=True)
    for extra in ([], ["--no_align", "--rpe_delta", "2"], ["--max_dt", "0"]):
        argv = ["eval", "--est", est, "--gt", gt] + extra
        rc_t = t_cli.main(argv)
        out_t = capsys.readouterr().out.strip().splitlines()[-1]
        rc_j = j_cli.main(argv)
        out_j = capsys.readouterr().out.strip().splitlines()[-1]
        assert rc_t == rc_j
        assert json.loads(out_t) == json.loads(out_j)
    assert json.loads(out_t) == {"error": "fewer than 2 associated poses"}


# -- utils ---------------------------------------------------------------------

def test_timer_running_average():
    Timer = t_timing.Timer
    Timer.reset()
    for _ in range(3):
        with Timer.measure("stage_a"):
            time.sleep(0.01)
    assert Timer.count("stage_a") == 3
    assert 5 <= Timer.average_ms("stage_a") <= 100
    Timer.log_all_average_time()  # smoke
    Timer.reset()
    assert Timer.count("stage_a") == 0


def test_sync_and_device_time_on_the_cpu():
    """``sync`` waits for nothing on CPU tensors.  The card's time is read
    from torch.profiler with the phase spans beside it (``timing``), not
    from a helper of ``profiling``, which keeps ScanStats alone."""
    t_timing.sync({"a": torch.ones(2), "b": (torch.zeros(1), [torch.ones(3)])})
    assert not hasattr(t_prof, "device_time") and not hasattr(t_prof, "trace")


def test_scan_stats_report():
    s = t_prof.ScanStats()
    s.update(n_raw=10000, n_points=2000, n_matched=1500)
    s.update(n_raw=10000, n_points=2000, n_matched=1700, dropped_events=1)
    r = s.report()
    assert r["scans"] == 2
    assert abs(r["match_ratio"] - 0.8) < 1e-6
    assert r["dropped_events"] == 1
    assert "match_ratio" in str(s)


def test_trace_writes_a_chrome_trace(tmp_path):
    """A chrome trace of a block from torch.profiler itself, the port's
    spans recorded beside it (README, "Tracing the port")."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_timing.record_spans() as spans:
            with t_timing.span("lk.step"):
                torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert [s[0] for s in spans] == ["lk.step"] and spans[0][1] <= spans[0][2]


def test_logging_setup_writes_file(tmp_path):
    log = t_logging.setup(log_dir=str(tmp_path), name="testlog")
    log.info("hello %d", 42)
    for h in logging.getLogger().handlers:
        h.flush()
    files = list(tmp_path.glob("testlog_*.log"))
    assert len(files) == 1
    assert "hello 42" in files[0].read_text()
    # Reset handlers so later tests aren't affected.
    logging.getLogger().handlers.clear()
    logging.basicConfig()


# -- native scan prep ----------------------------------------------------------

def test_native_library_loads():
    assert t_native.available() and j_native.available()


def test_native_process_scan_matches_jax_and_numpy(rng):
    """As tests/test_native.py:20-66 holds the JAX package: the port's
    binding gives the JAX binding's outputs exactly, and the numpy path's
    buckets as sets."""
    n, nb, pmax, leaf = 3000, 32, 256, 0.4
    pts = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    toff = np.sort(rng.uniform(0, 0.05, n)).astype(np.float32)
    inten = rng.uniform(0, 255, n).astype(np.float32)
    for intensity in (inten, None):
        got = t_native.process_scan(pts, toff, 2, 1.0, leaf, True, nb, pmax, intensity=intensity)
        ref = j_native.process_scan(pts, toff, 2, 1.0, leaf, True, nb, pmax, intensity=intensity)
        for a, b in zip(got, ref):
            assert (a is None and b is None) or np.array_equal(a, b)
    bt, bm, p, pm, ndown, dropped, it = t_native.process_scan(
        pts, toff, 2, 1.0, leaf, True, nb, pmax, intensity=inten)
    p2, t2, i2 = t_ds.decimate_blind(pts, toff, 2, 1.0, intensity=inten)
    t2 = t_ds.quantize_times(t2)
    p2, t2, i2 = t_ds.voxel_downsample(p2, t2, leaf, i2)
    t2 = t_ds.quantize_times(t2)
    assert ndown == len(p2)
    uniq = np.unique(t2)
    k = min(len(uniq), nb)
    np.testing.assert_allclose(bt[:k], uniq[:k], atol=1e-7)
    assert bm[:k].all()
    for i in range(k):
        ref = np.sort(p2[t2 == uniq[i]][:pmax], axis=0)
        ours = np.sort(p[i][pm[i]], axis=0)
        assert len(ours) == len(ref)
        np.testing.assert_allclose(ours, ref, atol=1e-5)
        np.testing.assert_allclose(np.sort(it[i][pm[i]]), np.sort(i2[t2 == uniq[i]][:pmax]), atol=1e-4)
    assert pm.sum() + dropped == len(p2)


def test_native_decimate_blind_matches_jax_and_numpy(rng):
    pts = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    got = t_native.decimate_blind(pts, 3, 1.5)
    assert np.array_equal(got, j_native.decimate_blind(pts, 3, 1.5))
    ref, _, _ = t_ds.decimate_blind(pts, np.zeros(500, np.float32), 3, 1.5)
    np.testing.assert_allclose(got, ref, atol=1e-7)


def _builder_cfg(use_native, quantum=2.0):
    cfg = t_config.Config()
    cfg.lidar.filter_num, cfg.lidar.blind, cfg.lidar.voxel_grid_resolution = 1, 0.5, 0.4
    cfg.tpu.max_buckets, cfg.tpu.max_points_per_bucket = 20, 192
    cfg.tpu.use_native, cfg.tpu.bucket_quantum_ms = use_native, quantum
    return cfg


def test_packet_builder_native_matches_numpy(rng):
    """tests/test_native.py:69-110 on the port: 2 ms buckets with
    ``use_native`` on give the packets of the numpy path (bucket contents
    as sets), and the builder records which packetizer ran; 4 ms buckets
    take numpy whatever the switch says."""
    n = 1200
    pts = rng.uniform(1, 5, size=(n, 3)).astype(np.float32)
    toff = np.sort(rng.uniform(0, 0.03, n)).astype(np.float32)
    scan = t_ds.RawScan(begin_time=7.0, end_time=7.03, points=pts, time_offset=toff,
                        intensity=rng.uniform(0, 255, n).astype(np.float32))
    ev = [t_ds.ImuEvent(time=7.001, acc=np.ones(3), gyr=np.zeros(3))]
    ba, bb = t_ds.PacketBuilder(_builder_cfg(True)), t_ds.PacketBuilder(_builder_cfg(False))
    a, b = ba.build_packet(scan, ev), bb.build_packet(scan, ev)
    assert (ba.packetizer, bb.packetizer) == ("native", "numpy")
    np.testing.assert_allclose(a.bucket_time, b.bucket_time, atol=1e-7)
    for f in ("bucket_mask", "imu_mask", "imu_time", "imu_acc", "imu_gyr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.point_mask.sum(1), b.point_mask.sum(1))
    assert (a.dropped_points, a.dropped_events) == (b.dropped_points, b.dropped_events)
    for i in range(20):
        np.testing.assert_allclose(np.sort(a.points[i][a.point_mask[i]], axis=0),
                                   np.sort(b.points[i][b.point_mask[i]], axis=0), atol=1e-5)
        np.testing.assert_allclose(np.sort(a.intensity[i][a.point_mask[i]]),
                                   np.sort(b.intensity[i][b.point_mask[i]]), atol=1e-4)
    b4 = t_ds.PacketBuilder(_builder_cfg(True, quantum=4.0))
    b4.build_packet(scan, ev)
    assert b4.packetizer == "numpy"


def test_packet_builder_takes_numpy_where_native_keys_a_leaf_cell_apart(rng):
    """A point on a leaf boundary (x = 2.0 at a 0.4 m leaf: numpy's float32
    quotient keys it to cell 5, the library's float64 product to cell 4)
    would give the library's packet other centroids; the 2 ms builder then
    takes the numpy path, and its packet is the numpy builder's.  The same
    scan with the point off the boundary takes the library."""
    n = 400
    pts = rng.uniform(1, 5, size=(n, 3)).astype(np.float32)
    pts[:3] = [(1.9, 3.1, 3.1), (2.0, 3.1, 3.1), (2.1, 3.1, 3.1)]
    toff = np.sort(rng.uniform(0, 0.03, n)).astype(np.float32)
    toff[:3] = toff[0]
    for edge, want in ((2.0, "numpy"), (2.05, "native")):
        pts[1, 0] = edge
        scan = t_ds.RawScan(begin_time=7.0, end_time=7.03, points=pts.copy(), time_offset=toff)
        assert t_ds.native_keys_agree(pts, toff, 1, 0.5, 0.4) == (want == "native")
        b = t_ds.PacketBuilder(_builder_cfg(True))
        got = b.build_packet(scan, [])
        ref = t_ds.PacketBuilder(_builder_cfg(False)).build_packet(scan, [])
        assert b.packetizer == want
        rows = lambda p, m, i: np.sort(p[i][m[i]], axis=0)
        for i in range(20):
            np.testing.assert_allclose(rows(got.points, got.point_mask, i),
                                       rows(ref.points, ref.point_mask, i), atol=1e-5)
        # The three points share bucket 0: the library's centroids there
        # are numpy's only off the boundary.
        lib = t_native.process_scan(pts, toff, 1, 0.5, 0.4, True, 20, 192)
        same = np.allclose(rows(lib[2], lib[3], 0), rows(ref.points, ref.point_mask, 0), atol=1e-5)
        assert same == (want == "native")


def test_native_unavailable_falls_back_to_numpy_and_warns_once(rng, monkeypatch, caplog):
    monkeypatch.setattr(t_native, "LIB_PATH", "/nonexistent/libscanprep.so")
    t_native._lib.cache_clear()
    try:
        n = 400
        scan = t_ds.RawScan(begin_time=7.0, end_time=7.03,
                            points=rng.uniform(1, 5, size=(n, 3)).astype(np.float32),
                            time_offset=np.sort(rng.uniform(0, 0.03, n)).astype(np.float32))
        with caplog.at_level(logging.WARNING, logger=t_native.__name__):
            b = t_ds.PacketBuilder(_builder_cfg(True))
            pkts = [b.build_packet(scan, []) for _ in range(3)]
        ref = t_ds.PacketBuilder(_builder_cfg(False)).build_packet(scan, [])
        assert b.packetizer == "numpy" and not t_native.available()
        assert sum("native scan prep unavailable" in r.message for r in caplog.records) == 1
        assert all(np.array_equal(p.points, ref.points) for p in pkts)
    finally:
        t_native._lib.cache_clear()


# -- pcd -----------------------------------------------------------------------

def test_pcd_saver_files_match_jax(tmp_path, rng):
    """Five clouds, two a file, with intensity (one cloud masked, one with
    a non-finite and a far point): the same files byte for byte."""
    clouds = []
    for i in range(5):
        pts = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
        if i == 2:
            pts[0] = np.nan
            pts[1] = 2e6
        clouds.append((pts, rng.random(300) > 0.3 if i == 1 else None,
                       rng.uniform(0, 255, 300).astype(np.float32)))
    dirs = []
    for mod, sub in ((t_pcd, "t"), (j_pcd, "j")):
        saver = mod.PcdSaver(directory=str(tmp_path / sub), frames_per_file=2, leaf_size=0.2)
        for pts, mask, inten in clouds:
            saver.save(pts, mask=mask, intensity=inten)
        saver.close()
        dirs.append(saver.directory)
    files = sorted(p.name for p in (tmp_path / "t").glob("*/*.pcd"))
    assert files == ["map_0000.pcd", "map_0001.pcd", "map_0002.pcd"]
    for name in files:
        a = (pathlib.Path(dirs[0]) / name).read_bytes()
        assert a == (pathlib.Path(dirs[1]) / name).read_bytes(), name
        path = str(pathlib.Path(dirs[0]) / name)
        assert np.array_equal(t_pcd.read_pcd(path), j_pcd.read_pcd(path))
    t_pcd.write_pcd(str(tmp_path / "x.pcd"), clouds[0][0])
    j_pcd.write_pcd(str(tmp_path / "y.pcd"), clouds[0][0])
    assert (tmp_path / "x.pcd").read_bytes() == (tmp_path / "y.pcd").read_bytes()


# -- plane export --------------------------------------------------------------

def _jax_plane_map(rng, storage):
    """A map the JAX package built: two levels, a near-flat floor and a wall."""
    import jax.numpy as jnp

    cfg = j_vmap.MapConfig(levels=2, capacity=512, probe=8, voxel_size=0.5,
                           planer_threshold=0.01, sigma_num=3.0, max_points_num=50,
                           init_num=(5, 5), storage_dtype=storage)
    n = 900
    pts = np.zeros((n, 3))
    pts[:, 0] = rng.uniform(-2, 2, n)
    pts[:, 1] = rng.uniform(-2, 2, n)
    pts[:, 2] = 0.25 + rng.normal(scale=0.002, size=n)
    pts[600:, 2] = rng.uniform(0.0, 1.5, 300)      # a wall at x = 1.9
    pts[600:, 0] = 1.9 + rng.normal(scale=0.002, size=300)
    var = np.tile(np.eye(3)[None] * 1e-4, (n, 1, 1))
    vm = j_vmap.insert_points(j_vmap.make_map(cfg), cfg, jnp.asarray(pts, dtype=jnp.float32),
                              jnp.asarray(var, dtype=jnp.float32), jnp.ones(n, dtype=bool))
    return vm, cfg


@pytest.mark.parametrize("storage", ["f32", "f16"])
def test_plane_export_matches_jax(tmp_path, rng, storage):
    """The JAX package's map carried across with convert.py: the same
    planes to 1e-6 and the same PLY text.  With f16 storage the port casts
    the narrow tables to f32 on the host and sums the covariance trace in
    f32, where JAX sums it in f16: there ``var_trace`` agrees to f16's unit
    roundoff (2^-11, relative), the rest to 1e-6."""
    jvm, cfg = _jax_plane_map(rng, storage)
    scfg = j_filter.StaticConfig(map_cfg=cfg, use_kin=False, dept_err=0.04, beam_err=0.2)
    jcarry = j_filter.init_carry(scfg)._replace(vm=jvm)
    tvm = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jcarry)], "cpu").vm
    if storage == "f16":
        assert tvm.plane.dtype == torch.float16 and tvm.moms.dtype == torch.float16
    tcfg = t_vmap.MapConfig(*[getattr(cfg, f) for f in t_vmap.MapConfig._fields])
    tp, jp = t_pe.extract_planes(tvm, tcfg), j_pe.extract_planes(jvm, cfg)
    assert len(tp) == len(jp) >= 8
    assert {p["level"] for p in tp} == {0, 1}
    trace_rtol = 2.0 ** -11 if storage == "f16" else 0.0
    for a, b in zip(tp, jp):
        assert a["level"] == b["level"]
        for k in ("center", "normal", "evals"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(a["var_trace"], b["var_trace"], rtol=trace_rtol, atol=1e-6)
    n_t = t_pe.export_plane_map(tvm, tcfg, str(tmp_path / "t.ply"), str(tmp_path / "t.json"))
    n_j = j_pe.export_plane_map(jvm, cfg, str(tmp_path / "j.ply"), str(tmp_path / "j.json"))
    assert n_t == n_j == len(tp)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()
    assert json.loads((tmp_path / "t.json").read_text()) == tp


def test_map_accessors_match_jax(rng):
    jvm, _ = _jax_plane_map(rng, "f32")
    tvm = t_vmap.VoxelMap(*[torch.from_numpy(np.array(x)) for x in jvm])
    assert np.asarray(jvm.is_plane()).any()
    for name in ("key", "occ"):
        assert np.array_equal(getattr(tvm, name).numpy(), np.asarray(getattr(jvm, name))), name
    for name in ("is_plane", "center_rel", "normal", "evals", "plane_var"):
        assert np.array_equal(getattr(tvm, name)().numpy(), np.asarray(getattr(jvm, name)())), name


# -- end to end: bags through run ------------------------------------------------

_PACKET_FIELDS = ("begin_time", "end_time", "rebase", "end_offset", "bucket_time", "bucket_mask",
                  "points", "point_mask", "imu_time", "imu_mask", "imu_acc", "imu_gyr", "foot_pos",
                  "foot_vel", "contact", "n_raw", "dropped_points", "dropped_events", "intensity")


def _decode_packets(rb, lidar, ut, ds, config, bag, cfg_path):
    """A bag through one package's reader, decoders and packetizer (as its
    ``run`` feeds them, with ``redundancy`` off)."""
    cfg = config.load(cfg_path)
    b, kin = ds.PacketBuilder(cfg), ut.Kinematics(cfg.kinematics)
    pkts = []
    with rb.BagReader(bag) as reader:
        for msg in reader.messages([cfg.lidar_topic, cfg.imu_topic, cfg.kinematic_topic]):
            if msg.topic == cfg.lidar_topic:
                b.add_scan(lidar.decode(rb.parse_pointcloud2(msg.raw), cfg.lidar))
            elif msg.topic == cfg.imu_topic:
                imu = rb.parse_imu(msg.raw)
                b.add_imu(ds.ImuEvent(time=imu.stamp, acc=imu.linear_acceleration, gyr=imu.angular_velocity))
            else:
                hs = rb.parse_high_state(msg.raw)
                b.add_kin_imu(kin.processing(ut.HighState(
                    stamp=hs.stamp, accelerometer=hs.accelerometer, gyroscope=hs.gyroscope,
                    motor_q=hs.motor_q, motor_dq=hs.motor_dq, foot_force=hs.foot_force)))
            while b.ready():
                pkts.append(b.pop())
    return pkts


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    d = tmp_path_factory.mktemp("bags")
    return {kin: write_bag_run(d, kin) for kin in (False, True)}


@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_bag_packets_match_jax(bags, use_kin):
    bag, cfg_path, _, data = bags[use_kin]
    tp = _decode_packets(t_rb, t_lidar, t_ut, t_ds, t_config, bag, cfg_path)
    jp = _decode_packets(j_rb, j_lidar, j_ut, j_ds, j_config, bag, cfg_path)
    assert len(tp) == len(jp) >= len(data.scans)
    for i, (a, b) in enumerate(zip(tp, jp)):
        for f in _PACKET_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or np.array_equal(x, y), (i, f)
    assert any(p.intensity is not None and p.intensity.any() for p in tp)
    if use_kin:
        assert any(p.contact.any() for p in tp) and any((~p.contact & p.imu_mask[..., None]).any() for p in tp)


@pytest.fixture(scope="module")
def port_runs(bags, tmp_path_factory):
    """``python -m legkilo_torch run --device cpu`` on both bags with every
    output on; (traj path, plane PLY path, PCD dir, printed JSON) each, and
    a checkpoint beside the trajectory (``.npz``)."""
    d = tmp_path_factory.mktemp("port_runs")
    out = {}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for use_kin, (bag, cfg_path, _, _) in bags.items():
            tag = "kin" if use_kin else "imu"
            traj, ply, pcd = str(d / f"{tag}.txt"), str(d / f"{tag}.ply"), d / f"{tag}_pcd"
            argv = ["run", "--device", "cpu", "--config_file", cfg_path, "--bag", bag,
                    "--traj_out", traj, "--export_planes", ply, "--save_pcd", str(pcd),
                    "--save_ckpt", str(d / f"{tag}.npz")]
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert t_cli.main(argv) == 0
            out[use_kin] = (traj, ply, pcd, json.loads(buf.getvalue().strip().splitlines()[-1]))
    finally:
        torch.set_num_threads(n_threads)
        logging.getLogger().handlers.clear()
    return out


@pytest.mark.parametrize("use_kin,bound", [(False, 0.08), (True, 0.12)], ids=["imu", "kin"])
def test_run_bag_within_the_jax_bounds(bags, port_runs, use_kin, bound):
    """ATE bounds of tests/test_bag_e2e.py (0.08 m Imu, 0.12 m HighState);
    a PLY of > 100 vertices; the registered clouds as a PCD file; the
    printed JSON; a checkpoint in the JAX package's format at the end."""
    _, _, _, data = bags[use_kin]
    traj, ply, pcd, rec = port_runs[use_kin]
    ate, pairs = bag_ate(traj, data)
    assert pairs >= 18, pairs
    assert np.isfinite(ate) and ate < bound, f"bag ATE {ate:.4f} m"
    text = open(ply).read()
    assert text.startswith("ply")
    assert int([l for l in text.splitlines() if l.startswith("element vertex")][0].split()[-1]) > 100
    files = sorted(pcd.glob("*/*.pcd"))
    assert len(files) == 1
    cloud = t_pcd.read_pcd(str(files[0]))
    assert len(cloud) > 1000 and np.isfinite(cloud).all()
    assert rec["scans"] >= len(data.scans) and rec["packetizer"] == "numpy"
    assert rec["messages"] == len(data.scans) + len(data.kin if use_kin else data.imu)
    assert rec["decode_ms"] > 0 and rec["step_ms"] > 0 and 0.3 < rec["match_ratio"] <= 1.0
    carry, step, extras = convert.load_jax_checkpoint(traj[:-len(".txt")] + ".npz", "cpu")
    assert step == rec["scans"] and bool(int(extras["use_kin"])) == use_kin
    assert int(carry.vm.ptab[:, 3].sum()) > 0


@pytest.fixture(scope="module")
def jax_imu_runs(bags, tmp_path_factory):
    """JAX ``run`` on the Imu bag on its kernel path (interpret mode) and
    on its XLA path (every switch off): the trajectories."""
    d = tmp_path_factory.mktemp("jax_runs")
    bag, cfg_path, _, _ = bags[False]
    xla_cfg = d / "xla.yaml"
    xla_cfg.write_text(BAG_RUN_YAML.format(only_imu_use="true", kernels="false"))
    out = []
    try:
        for i, c in enumerate((cfg_path, str(xla_cfg))):
            traj = str(d / f"jax_{i}.txt")
            assert j_cli.main(["run", "--config_file", c, "--bag", bag, "--traj_out", traj]) == 0
            out.append(np.loadtxt(traj))
    finally:
        logging.getLogger().handlers.clear()
    return out


def test_run_bag_tracks_jax_run(port_runs, jax_imu_runs):
    """The port's ``run`` against JAX's on the Imu bag, pose by pose,
    under tests/test_torch_slice.py's rule: within 4x the JAX package's
    own spread so far (its kernel path against its XLA path, the same
    computation rounded differently), plus 0.1 mm."""
    jk, jx = jax_imu_runs
    tt = np.loadtxt(port_runs[False][0])
    assert tt.shape == jk.shape == jx.shape
    assert np.array_equal(tt[:, 0], jk[:, 0])
    spread = np.maximum.accumulate(np.abs(jk[:, 1:4] - jx[:, 1:4]).max(axis=1))
    diff = np.abs(tt[:, 1:4] - jk[:, 1:4]).max(axis=1)
    tol = 4 * spread + 1e-4
    assert (diff <= tol).all(), (diff - tol).max()
    assert spread[-1] < 1e-2
