"""Pure-Python ROS1 bag (v2.0) reader — no ROS installation required.

The port's own copy of ``legkilo_tpu/io/rosbag.py`` (numpy and ``struct``).
The reference consumes datasets via ``rosbag play`` into a live ROS node
(SURVEY.md §4.1).  This module reads the same .bag files directly: record
parsing, chunk decompression (none/bz2; an lz4 chunk needs the ``lz4``
module and raises ImportError without it; any other compression raises
ValueError, so no chunk is skipped silently), connection bookkeeping, and
binary deserialization of the three message types the pipeline needs:

  * sensor_msgs/PointCloud2  -> structured numpy array per vendor field
  * sensor_msgs/Imu          -> ImuMsg
  * unitree_legged_msgs/HighState -> HighStateMsg (layout from
    unitree_legged_msgs/msg/HighState.msg)

ROS1 serialization is little-endian packed with uint32 length-prefixed
strings/arrays; fixed-size arrays are not length-prefixed.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_U32 = struct.Struct("<I")


def _read_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = _U32.unpack_from(buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


@dataclasses.dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str
    md5sum: str


@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str
    time: float          # record receive time (secs)
    raw: bytes           # serialized message body


class BagReader:
    """Streaming reader over a ROS1 v2.0 bag file."""

    MAGIC = b"#ROSBAG V2.0\n"

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic = self._f.read(len(self.MAGIC))
        if magic != self.MAGIC:
            raise ValueError(f"{path}: not a ROS1 v2.0 bag (magic {magic!r})")
        self.connections: Dict[int, Connection] = {}

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_record(self, stream) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
        head = stream.read(4)
        if len(head) < 4:
            return None
        (hlen,) = _U32.unpack(head)
        header = _read_header(stream.read(hlen))
        (dlen,) = _U32.unpack(stream.read(4))
        data = stream.read(dlen)
        return header, data

    def messages(self, topics: Optional[List[str]] = None) -> Iterator[BagMessage]:
        """Yield messages in file order (bag chunks are time-ordered)."""
        want = set(topics) if topics else None
        while True:
            rec = self._read_record(self._f)
            if rec is None:
                return
            header, data = rec
            op = header.get(b"op", b"\x00")[0]
            if op == 0x07:  # connection
                self._add_connection(header, data)
            elif op == 0x05:  # chunk
                comp = header.get(b"compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp == "lz4":
                    import lz4.frame  # type: ignore

                    data = lz4.frame.decompress(data)
                elif comp != "none":
                    raise ValueError(f"unsupported chunk compression {comp}")
                yield from self._chunk_messages(data, want)
            # 0x02 outside chunks (unchunked bags) is rare but legal:
            elif op == 0x02:
                msg = self._message_from(header, data, want)
                if msg:
                    yield msg

    def _add_connection(self, header: Dict[bytes, bytes], data: bytes) -> None:
        conn_id = _U32.unpack(header[b"conn"])[0]
        topic = header[b"topic"].decode()
        conn_fields = _read_header(data)
        self.connections[conn_id] = Connection(
            conn_id=conn_id,
            topic=topic,
            msg_type=conn_fields.get(b"type", b"").decode(),
            md5sum=conn_fields.get(b"md5sum", b"").decode(),
        )

    def _chunk_messages(self, chunk: bytes, want) -> Iterator[BagMessage]:
        off = 0
        n = len(chunk)
        while off < n:
            (hlen,) = _U32.unpack_from(chunk, off)
            off += 4
            header = _read_header(chunk[off : off + hlen])
            off += hlen
            (dlen,) = _U32.unpack_from(chunk, off)
            off += 4
            data = chunk[off : off + dlen]
            off += dlen
            op = header.get(b"op", b"\x00")[0]
            if op == 0x07:
                self._add_connection(header, data)
            elif op == 0x02:
                msg = self._message_from(header, data, want)
                if msg:
                    yield msg

    def _message_from(self, header, data, want) -> Optional[BagMessage]:
        conn_id = _U32.unpack(header[b"conn"])[0]
        conn = self.connections.get(conn_id)
        if conn is None or (want and conn.topic not in want):
            return None
        secs, nsecs = struct.unpack("<II", header[b"time"])
        return BagMessage(
            topic=conn.topic,
            msg_type=conn.msg_type,
            time=secs + nsecs * 1e-9,
            raw=data,
        )


# ---------------------------------------------------------------------------
# Message deserialization
# ---------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def unpack(self, fmt: str):
        s = struct.Struct(fmt)
        v = s.unpack_from(self.buf, self.off)
        self.off += s.size
        return v

    def string(self) -> str:
        (n,) = self.unpack("<I")
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def bytes_(self, n: int) -> bytes:
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b

    def skip(self, n: int) -> None:
        self.off += n


def _read_ros_header(c: _Cursor) -> float:
    c.unpack("<I")  # seq
    secs, nsecs = c.unpack("<II")
    c.string()  # frame_id
    return secs + nsecs * 1e-9


@dataclasses.dataclass
class PointCloud2Msg:
    stamp: float
    height: int
    width: int
    fields: List[Tuple[str, int, int, int]]  # (name, offset, datatype, count)
    point_step: int
    data: bytes

    _DTYPES = {
        1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
        5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
    }

    def as_struct_array(self) -> np.ndarray:
        """View the payload as a structured numpy array (itemsize=point_step)."""
        names, formats, offsets = [], [], []
        for name, off, dt, count in self.fields:
            base = self._DTYPES[dt]
            names.append(name)
            formats.append(base if count == 1 else (base, (count,)))
            offsets.append(off)
        dtype = np.dtype(
            {"names": names, "formats": formats, "offsets": offsets,
             "itemsize": self.point_step}
        )
        n = self.width * self.height
        return np.frombuffer(self.data, dtype=dtype, count=n)


def parse_pointcloud2(raw: bytes) -> PointCloud2Msg:
    c = _Cursor(raw)
    stamp = _read_ros_header(c)
    height, width = c.unpack("<II")
    (nfields,) = c.unpack("<I")
    fields = []
    for _ in range(nfields):
        name = c.string()
        offset, datatype, count = c.unpack("<IBI")
        fields.append((name, offset, datatype, count))
    c.u8()  # is_bigendian
    point_step, row_step = c.unpack("<II")
    (dlen,) = c.unpack("<I")
    data = c.bytes_(dlen)
    return PointCloud2Msg(
        stamp=stamp, height=height, width=width, fields=fields,
        point_step=point_step, data=data,
    )


@dataclasses.dataclass
class ImuMsg:
    stamp: float
    orientation: np.ndarray          # [4] xyzw
    angular_velocity: np.ndarray     # [3]
    linear_acceleration: np.ndarray  # [3]


def parse_imu(raw: bytes) -> ImuMsg:
    c = _Cursor(raw)
    stamp = _read_ros_header(c)
    quat = np.array(c.unpack("<4d"))
    c.skip(9 * 8)
    gyr = np.array(c.unpack("<3d"))
    c.skip(9 * 8)
    acc = np.array(c.unpack("<3d"))
    c.skip(9 * 8)
    return ImuMsg(stamp=stamp, orientation=quat, angular_velocity=gyr,
                  linear_acceleration=acc)


@dataclasses.dataclass
class HighStateMsg:
    """unitree_legged_msgs/HighState essentials (HighState.msg layout)."""

    stamp: float
    accelerometer: np.ndarray  # [3]
    gyroscope: np.ndarray      # [3]
    motor_q: np.ndarray        # [20]
    motor_dq: np.ndarray       # [20]
    foot_force: np.ndarray     # [4]


# MotorState: mode u8, q f32, dq f32, ddq f32, tauEst f32, q_raw f32,
# dq_raw f32, ddq_raw f32, temperature i8, reserve u32[2]  (MotorState.msg)
_MOTOR_STATE = struct.Struct("<B7fb2I")
# BmsState: u8 x4, i32, u16, i8[2], i8[2], u16[10]  (BmsState.msg)
_BMS_SIZE = 4 + 4 + 2 + 2 + 2 + 20


def parse_high_state(raw: bytes) -> HighStateMsg:
    c = _Cursor(raw)
    secs, nsecs = c.unpack("<II")  # "time stamp" field (not a std_msgs Header)
    stamp = secs + nsecs * 1e-9
    c.skip(2 + 1 + 1)              # head[2], levelFlag, frameReserve
    c.skip(8 + 8 + 2)              # SN[2], version[2], bandWidth
    # IMU: quaternion f32[4], gyroscope f32[3], accelerometer f32[3],
    # rpy f32[3], temperature i8  (IMU.msg)
    imu_vals = c.unpack("<13f")
    c.skip(1)
    gyr = np.array(imu_vals[4:7], dtype=np.float64)
    acc = np.array(imu_vals[7:10], dtype=np.float64)
    q = np.zeros(20)
    dq = np.zeros(20)
    for i in range(20):
        vals = _MOTOR_STATE.unpack_from(c.buf, c.off)
        c.skip(_MOTOR_STATE.size)
        q[i], dq[i] = vals[1], vals[2]
    c.skip(_BMS_SIZE)
    foot_force = np.array(c.unpack("<4h"), dtype=np.float64)
    # Remaining fields (footForceEst, mode, ..., crc) are not needed.
    return HighStateMsg(
        stamp=stamp, accelerometer=acc, gyroscope=gyr,
        motor_q=q, motor_dq=dq, foot_force=foot_force,
    )
