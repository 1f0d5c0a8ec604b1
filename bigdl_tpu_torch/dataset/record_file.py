"""TFRecord framing and its masked CRC32C (the port's own copy of the
framing half of ``bigdl_tpu/dataset/record_file.py`` and of the CRC of
``bigdl_tpu/visualization/tensorboard.py``: reference ``RecordWriter.scala``
and the vendored ``netty/Crc32c.java``).

A record is ``u64 length``, ``u32 masked_crc(length bytes)``, the data and
``u32 masked_crc(data)``, little-endian, as TensorFlow writes it. The CRC
is the table-driven pure-Python one, about a second for a few MB; the
reference's native ctypes path (``utils/native.py``) waits for item 6 of
ROADMAP queue A (data), as do the sharded record files of this module's
reference.
"""

from __future__ import annotations

import struct

_CRC_TABLE = None


def _make_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data``."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        _CRC_TABLE = _make_table()
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord mask (reference ``RecordWriter.scala:35``)."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def write_framed(f, data):
    header = struct.pack("<Q", len(data))
    f.write(header)
    f.write(struct.pack("<I", masked_crc(header)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc(data)))


def read_framed(f):
    """Yield records from an open binary file, checking both CRCs. A bad
    CRC or a file cut mid-record raises ``IOError``."""
    while True:
        header = f.read(8)
        if len(header) < 8:
            if header:
                raise IOError(f"{f.name}: truncated record header")
            return
        (length,) = struct.unpack("<Q", header)
        raw = f.read(4)
        if len(raw) < 4:
            raise IOError(f"{f.name}: truncated record header crc")
        (hcrc,) = struct.unpack("<I", raw)
        if hcrc != masked_crc(header):
            raise IOError(f"{f.name}: corrupt record header")
        data = f.read(length)
        raw = f.read(4)
        if len(data) < length or len(raw) < 4:
            raise IOError(f"{f.name}: truncated record body")
        (dcrc,) = struct.unpack("<I", raw)
        if dcrc != masked_crc(data):
            raise IOError(f"{f.name}: corrupt record body")
        yield data
