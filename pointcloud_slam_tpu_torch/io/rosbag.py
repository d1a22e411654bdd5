"""Pure-Python ROS1 bag (format 2.0) reader + writer — no ROS dependency (a
copy of `pointcloud_slam_tpu/io/rosbag.py` on the port's own `lz4`).

Behavioral parity target: the reference's primary replay input is a recorded
rosbag (`src/jueying_lio/app/run_mapping_offline.cc:46-82` iterates
`rosbag::View` records and dispatches CustomMsg / PointCloud2 / Imu
callbacks). This module gives `apps/run_mapping_offline_torch.py --bag_file` the
same capability: it parses the bag container (records, chunks, connections)
and deserializes the three message types the LIO front-end consumes —
`sensor_msgs/Imu`, `sensor_msgs/PointCloud2` (any XYZIRT-style schema, via a
numpy structured dtype built from the PointField table), and
`livox_ros_driver/CustomMsg` (`thirdparty/livox_ros_driver/msg/CustomMsg.msg`).

The writer emits valid bags — unchunked by default, or chunked with
`none`/`bz2`/`lz4` compression (`chunk_compression=`); it exists for tests
and for `tools/make_dataset_torch.py`-style fixture synthesis. The reader handles
both unchunked records and chunks with compression `none`, `bz2` or `lz4`
(the rosbag default on many robots; decoded by the pure-Python LZ4 frame
codec in `io/lz4.py`).

Container format (http://wiki.ros.org/Bags/Format/2.0): the file starts with
`#ROSBAG V2.0\n`; each record is `<u32 header_len><header><u32 data_len>
<data>`; a header is a sequence of `<u32 len>name=value` fields; the `op`
field selects the record type.
"""

from __future__ import annotations

import bz2
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import lz4

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

# PointField.datatype -> numpy dtype (sensor_msgs/PointField constants)
_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4", 7: "f4", 8: "f8"}


# ---------------------------------------------------------------- container

def _pack_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        f = k + b"=" + v
        out += struct.pack("<I", len(f)) + f
    return out


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    o = 0
    while o < len(buf):
        (n,) = struct.unpack_from("<I", buf, o)
        f = buf[o + 4 : o + 4 + n]
        k, _, v = f.partition(b"=")
        fields[k] = v
        o += 4 + n
    return fields


def _iter_records(buf: bytes, offset: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    o = offset
    while o + 8 <= len(buf):
        (hl,) = struct.unpack_from("<I", buf, o)
        hdr = _parse_header(buf[o + 4 : o + 4 + hl])
        (dl,) = struct.unpack_from("<I", buf, o + 4 + hl)
        data = buf[o + 8 + hl : o + 8 + hl + dl]
        yield hdr, data
        o += 8 + hl + dl


class Connection:
    def __init__(self, cid: int, topic: str, msg_type: str):
        self.cid, self.topic, self.msg_type = cid, topic, msg_type


class BagReader:
    """Loads the record stream; `messages()` yields raw serialized messages."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(MAGIC):
            raise ValueError(f"{path}: not a ROS bag 2.0 file")
        self.connections: Dict[int, Connection] = {}
        self._msgs: List[Tuple[int, float, bytes]] = []  # (conn, t, raw)
        for hdr, data in _iter_records(buf, len(MAGIC)):
            self._record(hdr, data)

    def _record(self, hdr: Dict[bytes, bytes], data: bytes):
        op = hdr.get(b"op", b"\x00")[0]
        if op == OP_CHUNK:
            comp = hdr.get(b"compression", b"none").decode()
            if comp == "bz2":
                data = bz2.decompress(data)
            elif comp == "lz4":
                data = lz4.frame_decompress(data)
            elif comp != "none":
                raise NotImplementedError(f"bag chunk compression '{comp}' not supported")
            for h2, d2 in _iter_records(data):
                self._record(h2, d2)
        elif op == OP_CONNECTION:
            (cid,) = struct.unpack("<I", hdr[b"conn"])
            conn_hdr = _parse_header(data)
            self.connections[cid] = Connection(
                cid,
                hdr.get(b"topic", conn_hdr.get(b"topic", b"")).decode(),
                conn_hdr.get(b"type", b"").decode(),
            )
        elif op == OP_MSG:
            (cid,) = struct.unpack("<I", hdr[b"conn"])
            secs, nsecs = struct.unpack("<II", hdr[b"time"])
            self._msgs.append((cid, secs + nsecs * 1e-9, data))
        # OP_INDEX / OP_CHUNK_INFO / OP_BAG_HEADER: metadata only

    def messages(self, topics: Optional[List[str]] = None) -> Iterator[Tuple[str, str, float, bytes]]:
        """Yield (topic, msg_type, t_record, raw) sorted by record time."""
        for cid, t, raw in sorted(self._msgs, key=lambda m: m[1]):
            c = self.connections.get(cid)
            if c is None or (topics and c.topic not in topics):
                continue
            yield c.topic, c.msg_type, t, raw


class BagWriter:
    """Minimal bag writer (tests + dataset-fixture synthesis).

    Unchunked by default; `chunk_compression` in {"none", "bz2", "lz4"}
    groups records into compressed chunk records (the shape rosbag itself
    writes — lz4 is its common default), flushed at `chunk_size` bytes.
    """

    def __init__(self, path: str, chunk_compression: Optional[str] = None,
                 chunk_size: int = 1 << 20):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        # bag header record, padded to 4096 like rosbag does (index_pos=0
        # marks the bag unindexed; our reader scans records sequentially)
        hdr = _pack_header({
            b"op": bytes([OP_BAG_HEADER]),
            b"index_pos": struct.pack("<Q", 0),
            b"conn_count": struct.pack("<I", 0),
            b"chunk_count": struct.pack("<I", 0),
        })
        pad = b" " * (4096 - len(hdr) - 8)
        self._f.write(struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(pad)) + pad)
        self._conns: Dict[str, int] = {}
        if chunk_compression is not None and chunk_compression not in ("none", "bz2", "lz4"):
            raise ValueError(f"unsupported chunk compression '{chunk_compression}'")
        self._chunk_comp = chunk_compression
        self._chunk_size = chunk_size
        self._chunk_buf = bytearray()

    def _record(self, fields: Dict[bytes, bytes], data: bytes):
        hdr = _pack_header(fields)
        rec = struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data
        if self._chunk_comp is None:
            self._f.write(rec)
        else:
            self._chunk_buf += rec
            if len(self._chunk_buf) >= self._chunk_size:
                self._flush_chunk()

    def _flush_chunk(self):
        if not self._chunk_buf:
            return
        payload = bytes(self._chunk_buf)
        self._chunk_buf = bytearray()
        if self._chunk_comp == "bz2":
            data = bz2.compress(payload)
        elif self._chunk_comp == "lz4":
            data = lz4.frame_compress(payload)
        else:
            data = payload
        hdr = _pack_header({
            b"op": bytes([OP_CHUNK]),
            b"compression": self._chunk_comp.encode(),
            b"size": struct.pack("<I", len(payload)),
        })
        self._f.write(struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data)

    def _conn(self, topic: str, msg_type: str) -> int:
        if topic not in self._conns:
            cid = len(self._conns)
            self._conns[topic] = cid
            self._record(
                {b"op": bytes([OP_CONNECTION]), b"conn": struct.pack("<I", cid),
                 b"topic": topic.encode()},
                _pack_header({b"topic": topic.encode(), b"type": msg_type.encode(),
                              b"md5sum": b"*", b"message_definition": b""}),
            )
        return self._conns[topic]

    def write(self, topic: str, msg_type: str, t: float, raw: bytes):
        cid = self._conn(topic, msg_type)
        secs = int(t)
        nsecs = int(round((t - secs) * 1e9))
        self._record(
            {b"op": bytes([OP_MSG]), b"conn": struct.pack("<I", cid),
             b"time": struct.pack("<II", secs, nsecs)},
            raw,
        )

    def write_imu(self, topic: str, t: float, acc, gyro, orientation=(0, 0, 0, 1)):
        self.write(topic, "sensor_msgs/Imu", t, serialize_imu(t, acc, gyro, orientation))

    def write_pointcloud2(self, topic: str, t: float, cloud: Dict[str, np.ndarray]):
        self.write(topic, "sensor_msgs/PointCloud2", t, serialize_pointcloud2(t, cloud))

    def write_livox(self, topic: str, t: float, pts: np.ndarray, offset_time_ns: np.ndarray,
                    reflectivity=None, tag=None, line=None):
        self.write(topic, "livox_ros_driver/CustomMsg", t,
                   serialize_livox(t, pts, offset_time_ns, reflectivity, tag, line))

    def close(self):
        if self._chunk_comp is not None:
            self._flush_chunk()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ----------------------------------------------------- message (de)serializers

def _read_rostime(buf: bytes, o: int) -> Tuple[float, int]:
    secs, nsecs = struct.unpack_from("<II", buf, o)
    return secs + nsecs * 1e-9, o + 8


def _read_string(buf: bytes, o: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", buf, o)
    return buf[o + 4 : o + 4 + n], o + 4 + n


def _read_std_header(buf: bytes, o: int = 0) -> Tuple[float, int]:
    o += 4  # seq
    stamp, o = _read_rostime(buf, o)
    _, o = _read_string(buf, o)  # frame_id
    return stamp, o


def _header_bytes(t: float, frame_id: bytes = b"body") -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    return struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", len(frame_id)) + frame_id


def parse_imu(raw: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/Imu -> {stamp, orientation(4,), gyro(3,), acc(3,)}."""
    stamp, o = _read_std_header(raw)
    quat = np.frombuffer(raw, "<f8", 4, o)
    o += 4 * 8 + 9 * 8
    gyro = np.frombuffer(raw, "<f8", 3, o)
    o += 3 * 8 + 9 * 8
    acc = np.frombuffer(raw, "<f8", 3, o)
    return {"stamp": stamp, "orientation": np.asarray(quat),
            "gyro": np.asarray(gyro), "acc": np.asarray(acc)}


def serialize_imu(t: float, acc, gyro, orientation=(0, 0, 0, 1)) -> bytes:
    cov = struct.pack("<9d", *([0.0] * 9))
    return (_header_bytes(t)
            + struct.pack("<4d", *orientation) + cov
            + struct.pack("<3d", *gyro) + cov
            + struct.pack("<3d", *acc) + cov)


def parse_pointcloud2(raw: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/PointCloud2 -> dict of per-point field arrays + 'stamp'.

    Any field schema works (XYZIRT, XYZI, ouster t/ring, robosense
    timestamp, ...): the PointField table becomes a numpy structured dtype,
    so downstream converters (`point_times_from_cloud`, ring remaps) see the
    same field names the reference's PCL point types expose."""
    stamp, o = _read_std_header(raw)
    height, width = struct.unpack_from("<II", raw, o)
    o += 8
    (nf,) = struct.unpack_from("<I", raw, o)
    o += 4
    names, formats, offsets = [], [], []
    for _ in range(nf):
        name, o = _read_string(raw, o)
        f_off, f_dt, f_cnt = struct.unpack_from("<IBI", raw, o)
        o += 9
        names.append(name.decode())
        base = _PF_DTYPES[f_dt]
        formats.append(base if f_cnt == 1 else (base, (f_cnt,)))
        offsets.append(f_off)
    is_bigendian = raw[o]
    o += 1
    point_step, _row_step = struct.unpack_from("<II", raw, o)
    o += 8
    (dn,) = struct.unpack_from("<I", raw, o)
    o += 4
    data = raw[o : o + dn]
    o += dn
    is_dense = raw[o] if o < len(raw) else 1
    if is_bigendian:
        raise NotImplementedError("big-endian PointCloud2")
    dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                   "itemsize": point_step})
    arr = np.frombuffer(data, dt, height * width)
    out: Dict[str, np.ndarray] = {n: np.ascontiguousarray(arr[n]) for n in names}
    out["stamp"] = stamp
    out["is_dense"] = bool(is_dense)
    return out


def serialize_pointcloud2(t: float, cloud: Dict[str, np.ndarray]) -> bytes:
    names = [k for k in cloud.keys() if k not in ("stamp", "is_dense")]
    arrs = [np.asarray(cloud[k]) for k in names]
    n = len(arrs[0])
    offsets, fields_bin, off = [], b"", 0
    for name, a in zip(names, arrs):
        code = {np.dtype(v): k for k, v in _PF_DTYPES.items()}[a.dtype.newbyteorder("<")]
        fields_bin += (struct.pack("<I", len(name)) + name.encode()
                       + struct.pack("<IBI", off, code, 1))
        offsets.append(off)
        off += a.dtype.itemsize
    point_step = off
    dt = np.dtype({"names": names, "formats": [a.dtype.str for a in arrs],
                   "offsets": offsets, "itemsize": point_step})
    rec = np.zeros(n, dt)
    for name, a in zip(names, arrs):
        rec[name] = a
    data = rec.tobytes()
    return (_header_bytes(t)
            + struct.pack("<II", 1, n)
            + struct.pack("<I", len(names)) + fields_bin
            + b"\x00"
            + struct.pack("<II", point_step, point_step * n)
            + struct.pack("<I", len(data)) + data
            + b"\x01")


def parse_livox(raw: bytes) -> Dict[str, np.ndarray]:
    """livox_ros_driver/CustomMsg (CustomMsg.msg:1-8 + CustomPoint.msg:1-9)."""
    stamp, o = _read_std_header(raw)
    (timebase,) = struct.unpack_from("<Q", raw, o)
    o += 8
    (point_num,) = struct.unpack_from("<I", raw, o)
    o += 4
    lidar_id = raw[o]
    o += 1 + 3  # lidar_id + rsvd[3]
    (npts,) = struct.unpack_from("<I", raw, o)
    o += 4
    dt = np.dtype({"names": ["offset_time", "x", "y", "z", "reflectivity", "tag", "line"],
                   "formats": ["<u4", "<f4", "<f4", "<f4", "u1", "u1", "u1"],
                   "itemsize": 19})
    arr = np.frombuffer(raw, dt, npts, o)
    return {"stamp": stamp, "timebase": timebase, "point_num": point_num,
            "lidar_id": lidar_id,
            **{k: np.ascontiguousarray(arr[k]) for k in dt.names}}


def serialize_livox(t: float, pts: np.ndarray, offset_time_ns: np.ndarray,
                    reflectivity=None, tag=None, line=None) -> bytes:
    n = len(pts)
    dt = np.dtype({"names": ["offset_time", "x", "y", "z", "reflectivity", "tag", "line"],
                   "formats": ["<u4", "<f4", "<f4", "<f4", "u1", "u1", "u1"],
                   "itemsize": 19})
    rec = np.zeros(n, dt)
    rec["offset_time"] = np.asarray(offset_time_ns, np.uint32)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rec["reflectivity"] = 100 if reflectivity is None else reflectivity
    rec["tag"] = 0x10 if tag is None else tag  # valid-return tag
    rec["line"] = 0 if line is None else line
    return (_header_bytes(t, b"livox_frame")
            + struct.pack("<Q", int(t * 1e9))
            + struct.pack("<I", n)
            + bytes([0, 0, 0, 0])
            + struct.pack("<I", n) + rec.tobytes())


_PARSERS = {
    "sensor_msgs/Imu": parse_imu,
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "livox_ros_driver/CustomMsg": parse_livox,
    "livox_ros_driver2/CustomMsg": parse_livox,
}


def read_bag(path: str, topics: Optional[List[str]] = None
             ) -> Iterator[Tuple[str, str, float, Dict[str, np.ndarray]]]:
    """Yield (topic, msg_type, t_record, parsed) for supported message types,
    sorted by record time; unsupported types are skipped."""
    reader = BagReader(path)
    for topic, msg_type, t, raw in reader.messages(topics):
        parser = _PARSERS.get(msg_type)
        if parser is not None:
            yield topic, msg_type, t, parser(raw)
