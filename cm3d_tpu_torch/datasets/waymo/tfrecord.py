"""TFRecord container I/O (TF-free).

The Waymo Open Dataset ships as TFRecord files of serialized Frame protos;
the reference reads them through tf.data (src/waymo/2d_to_3d.py:444-446).
The wire format is simple and stable:

  uint64 length (LE) | uint32 masked_crc32c(length) |
  bytes payload      | uint32 masked_crc32c(payload)

masked_crc = rotr15(crc32c(data)) + 0xa282ead8 (mod 2^32).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator

import numpy as np

_CRC_TABLE = None
_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected


def _table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        t = np.zeros(256, np.uint32)
        for i in range(256):
            c = np.uint32(i)
            for _ in range(8):
                c = (c >> np.uint32(1)) ^ (
                    np.uint32(_POLY) * (c & np.uint32(1))
                )
            t[i] = c
        _CRC_TABLE = t
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    t = _table()
    crc = np.uint32(0xFFFFFFFF)
    for b in np.frombuffer(data, np.uint8):
        crc = t[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    def __init__(self, path: str | Path):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def index_records(path: str | Path) -> list:
    """One pass over a TFRecord file collecting (payload_offset, length)
    per record — enables random access without re-reading payloads."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            f.seek(4, 1)  # header crc
            out.append((f.tell(), length))
            f.seek(length + 4, 1)  # payload + payload crc


def read_record(path: str | Path, offset: int, length: int,
                check_crc: bool = True) -> bytes:
    """Read one payload found by index_records."""
    with open(path, "rb") as f:
        f.seek(offset)
        payload = f.read(length)
        if len(payload) < length:
            raise IOError(f"{path}@{offset}: truncated payload "
                          f"({len(payload)}/{length} bytes)")
        if check_crc:
            crc_b = f.read(4)
            if len(crc_b) < 4:
                raise IOError(f"{path}@{offset}: truncated payload CRC")
            (pcrc,) = struct.unpack("<I", crc_b)
            if masked_crc(payload) != pcrc:
                raise IOError(f"{path}@{offset}: payload CRC mismatch")
    return payload


class TFRecordReader:
    def __init__(self, path: str | Path, check_crc: bool = True):
        self.path = Path(path)
        self.check_crc = check_crc

    def __iter__(self) -> Iterator[bytes]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) == 0:
                    return
                if len(header) < 8:
                    raise IOError(f"{self.path}: truncated record header")
                (length,) = struct.unpack("<Q", header)
                hcrc_b = f.read(4)
                if len(hcrc_b) < 4:
                    raise IOError(f"{self.path}: truncated header CRC")
                (hcrc,) = struct.unpack("<I", hcrc_b)
                payload = f.read(length)
                if len(payload) < length:
                    raise IOError(f"{self.path}: truncated payload "
                                  f"({len(payload)}/{length} bytes)")
                pcrc_b = f.read(4)
                if len(pcrc_b) < 4:
                    raise IOError(f"{self.path}: truncated payload CRC")
                (pcrc,) = struct.unpack("<I", pcrc_b)
                if self.check_crc:
                    if masked_crc(header) != hcrc:
                        raise IOError(f"{self.path}: header CRC mismatch")
                    if masked_crc(payload) != pcrc:
                        raise IOError(f"{self.path}: payload CRC mismatch")
                yield payload
