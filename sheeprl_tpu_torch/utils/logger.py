"""Experiment logging (counterpart of sheeprl_tpu/utils/logger.py).

:class:`TensorBoardLogger` writes scalars as TensorBoard reads them, with the
standard library and numpy only (the card's host has neither tensorboardX
nor tensorboard): one ``events.out.tfevents.<time>.<host>`` file in the run's
log dir, a sequence of TFRecords (little-endian u64 length, masked CRC-32C
of the length, the payload, masked CRC-32C of the payload), each payload an
``Event`` protobuf encoded here by hand. The first event holds
``file_version = "brain.Event:2"``; each scalar is then one
``Event{wall_time, step, summary{value{tag, simple_value}}}``, its value a
float32 as tensorboardX writes it. Every record is flushed when written, and
a failed write raises. :func:`read_scalars` reads such files back, those of
tensorboardX too, checking both CRCs of every record.

Log dirs are ``<root_dir>/<run_name>/version_<N>``, N one more than the
largest there (:func:`_versioned_dir`). The JAX package's :func:`get_log_dir`
puts a run without a logger under ``logs/runs``; the port's takes the root
from the caller, ``<log_root>/<root_dir>`` as the trainer passes it.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import warnings
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Tuple


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf encodes a negative step
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: Optional[str] = None, summary: Optional[bytes] = None) -> bytes:
    """An ``Event``: wall_time (1, double), step (2, int64), file_version (3,
    string), summary (5, message); zero and absent fields are omitted, as
    protobuf omits them."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3 | 0) + _varint(step)
    if file_version is not None:
        out += _length_delimited(3, file_version.encode())
    if summary is not None:
        out += _length_delimited(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    """``Summary{value{tag (1, string), simple_value (2, float)}}``."""
    value_msg = _length_delimited(1, tag.encode()) + _varint(2 << 3 | 5) + struct.pack("<f", value)
    return _length_delimited(1, value_msg)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return header + struct.pack("<I", masked_crc32c(header)) + payload + struct.pack("<I", masked_crc32c(payload))


class EventFileWriter:
    """Appends TFRecord-framed events to ``<log_dir>/events.out.tfevents.<time>.<host>``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}")
        self._fp: Optional[BinaryIO] = open(self.path, "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        if self._fp is None:
            raise ValueError(f"{self.path} is closed")
        self._fp.write(_record(payload))
        self._fp.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), int(step), summary=_scalar_summary(tag, float(value))))

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """(field number, wire type, value) of a protobuf message: an int for
    varints, bytes for the rest."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i : i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i : i + n], i + n
        elif wire == 5:
            value, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if i > len(buf):
            raise ValueError("truncated protobuf message")
        yield field, wire, value


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[i]
        i += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, i
        shift += 7


def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file. Raises on a torn record or a CRC mismatch."""
    with open(path, "rb") as fp:
        data = fp.read()
    i = 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: torn record header at byte {i}")
        header, (length_crc,) = data[i : i + 8], struct.unpack("<I", data[i + 8 : i + 12])
        if masked_crc32c(header) != length_crc:
            raise ValueError(f"{path}: length CRC mismatch at byte {i}")
        (length,) = struct.unpack("<Q", header)
        end = i + 12 + length + 4
        if end > len(data):
            raise ValueError(f"{path}: torn record at byte {i}")
        payload, (payload_crc,) = data[i + 12 : end - 4], struct.unpack("<I", data[end - 4 : end])
        if masked_crc32c(payload) != payload_crc:
            raise ValueError(f"{path}: payload CRC mismatch at byte {i}")
        yield payload
        i = end


def read_scalars(path: str) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value), ...]} of every scalar (``simple_value``) in an
    event file, or in every ``events.out.tfevents.*`` file of a directory (in
    name order), in the order written. Raises on a torn or corrupt record."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.startswith("events.out.tfevents."))
    else:
        files = [path]
    scalars: Dict[str, List[Tuple[int, float]]] = {}
    for file in files:
        for payload in read_records(file):
            step, summaries = 0, []
            for field, _, value in _fields(payload):
                if field == 2:
                    step = value - (1 << 64) if value >= 1 << 63 else value
                elif field == 5:
                    summaries.append(value)
            for summary in summaries:
                for field, _, value_msg in _fields(summary):
                    if field != 1:
                        continue
                    tag, simple = None, None
                    for f, _, v in _fields(value_msg):
                        if f == 1:
                            tag = v.decode()
                        elif f == 2:
                            (simple,) = struct.unpack("<f", v)
                    if tag is not None and simple is not None:
                        scalars.setdefault(tag, []).append((step, simple))
    return scalars


class TensorBoardLogger:
    """The log / log_dict / log_hyperparams / close surface the algorithms use."""

    def __init__(self, root_dir: str, run_name: str):
        self.root_dir = root_dir
        self.run_name = run_name
        self._log_dir = _versioned_dir(os.path.join(root_dir, run_name))
        self._writer: Optional[EventFileWriter] = None

    @property
    def log_dir(self) -> str:
        return self._log_dir

    @property
    def writer(self) -> EventFileWriter:
        if self._writer is None:
            self._writer = EventFileWriter(self._log_dir)
        return self._writer

    def log(self, name: str, value: Any, step: int) -> None:
        self.writer.add_scalar(name, float(value), step)

    def log_dict(self, metrics: Dict[str, Any], step: int) -> None:
        for k, v in metrics.items():
            self.log(k, v, step)

    def log_hyperparams(self, cfg: Dict[str, Any]) -> None:
        os.makedirs(self._log_dir, exist_ok=True)
        with open(os.path.join(self._log_dir, "hparams.json"), "w") as fp:
            json.dump(cfg, fp, default=str, indent=2)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _versioned_dir(save_dir: str) -> str:
    """``<save_dir>/version_<N>``, N one more than the largest ``version_<n>``
    directory there, 0 if there is none (reference: sheeprl/utils/logger.py:66-85).
    The directory is not made here."""
    try:
        existing = [
            int(d.split("_")[1])
            for d in os.listdir(save_dir)
            if d.startswith("version_") and d.split("_")[1].isdigit() and os.path.isdir(os.path.join(save_dir, d))
        ]
    except OSError:
        existing = []
    version = max(existing) + 1 if existing else 0
    return os.path.join(save_dir, f"version_{version}")


def get_logger(cfg) -> Optional[TensorBoardLogger]:
    """The run's TensorBoard logger under ``<log_root>/<root_dir>/<run_name>``,
    or None when ``metric.log_level`` is 0 (reference: logger.py:12-38)."""
    if cfg.metric.log_level <= 0:
        return None
    root_dir = os.path.join(cfg.log_root, cfg.root_dir)
    if root_dir != cfg.metric.logger.root_dir:
        warnings.warn(
            "The specified root directory for the TensorBoardLogger is different from the experiment one, "
            "so the logger one will be ignored and replaced with the experiment root directory",
            UserWarning,
        )
    cfg.metric.logger.root_dir = root_dir
    cfg.metric.logger.run_name = cfg.run_name
    return TensorBoardLogger(root_dir=root_dir, run_name=cfg.run_name)


def get_log_dir(root_dir: str, run_name: str, logger: Optional[TensorBoardLogger] = None) -> str:
    """Make and return the run's log dir: the logger's, or a new
    ``<root_dir>/<run_name>/version_<N>`` (reference: logger.py:41-89)."""
    log_dir = logger.log_dir if logger is not None else _versioned_dir(os.path.join(root_dir, run_name))
    os.makedirs(log_dir, exist_ok=True)
    return log_dir
