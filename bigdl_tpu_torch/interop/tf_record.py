"""TFRecord / tf.Example interop (the port of
``bigdl_tpu/interop/tf_record.py``: reference ``utils/tf/TFRecordIterator``,
``TFRecordWriter``, ``nn/tf/ParsingOps.scala`` and
``FixedLengthRecordReader``), the input format through which BigDL reads
data TensorFlow produced.

Records are framed by ``dataset/record_file.py`` (length and masked
CRC32C); an Example is decoded and encoded with ``utils/protowire.py``, so
both packages write the same bytes for the same features. Everything here
runs on the host and returns numpy arrays and bytes.
"""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.record_file import read_framed, write_framed
from bigdl_tpu_torch.utils import protowire

# ------------------------------------------------------- Example pb schema

BYTES_LIST = {1: ("value[]", "bytes")}
FLOAT_LIST = {1: ("value[]", "floats_packed")}
INT64_LIST = {1: ("value[]", "int")}
FEATURE = {1: ("bytes_list", ("msg", BYTES_LIST)),
           2: ("float_list", ("msg", FLOAT_LIST)),
           3: ("int64_list", ("msg", INT64_LIST))}
FEATURE_ENTRY = {1: ("key", "string"), 2: ("value", ("msg", FEATURE))}
FEATURES = {1: ("feature[]", ("msg", FEATURE_ENTRY))}
EXAMPLE = {1: ("features", ("msg", FEATURES))}


def parse_example(blob: bytes) -> dict:
    """tf.Example bytes -> ``{key: ndarray | list[bytes]}``: a bytes
    feature as its list of bytes, a float one float32, an int64 one
    int64."""
    msg = protowire.decode(blob, EXAMPLE)
    out = {}
    for entry in msg.get("features", {}).get("feature", []):
        key, feat = entry.get("key"), entry.get("value", {})
        if "bytes_list" in feat:
            out[key] = feat["bytes_list"].get("value", [])
        elif "float_list" in feat:
            out[key] = np.asarray(feat["float_list"].get("value", []),
                                  np.float32)
        elif "int64_list" in feat:
            out[key] = np.asarray(feat["int64_list"].get("value", []),
                                  np.int64)
        else:
            out[key] = np.asarray([])
    return out


def build_example(features: dict) -> bytes:
    """``{key: bytes | list[bytes] | float array | int array}`` ->
    tf.Example bytes."""
    entries = []
    for key, v in features.items():
        if isinstance(v, bytes):
            feat = {"bytes_list": {"value": [v]}}
        elif isinstance(v, (list, tuple)) and v \
                and isinstance(v[0], (bytes, bytearray)):
            feat = {"bytes_list": {"value": [bytes(b) for b in v]}}
        else:
            a = np.asarray(v)
            if np.issubdtype(a.dtype, np.integer):
                feat = {"int64_list": {"value": [int(i) for i in a.ravel()]}}
            else:
                feat = {"float_list": {"value": a.ravel()}}
        entries.append({"key": key, "value": feat})
    return protowire.encode({"features": {"feature": entries}}, EXAMPLE)


# ---------------------------------------------------------------- readers

def tf_record_iterator(path):
    """Yield the raw records of a ``.tfrecord`` file; a bad CRC or a cut
    file raises ``IOError``."""
    with open(path, "rb") as f:
        yield from read_framed(f)


def read_tf_examples(path):
    """Yield the parsed feature dicts of a ``.tfrecord`` of tf.Examples."""
    for blob in tf_record_iterator(path):
        yield parse_example(blob)


class TFRecordWriter:
    """Frames records into a file (reference ``TFRecordWriter``)."""

    def __init__(self, path):
        self._f = open(path, "wb")

    def write(self, blob: bytes):
        write_framed(self._f, blob)

    def write_example(self, features: dict):
        self.write(build_example(features))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FixedLengthRecordReader:
    """Fixed-size binary records after a header and before a footer
    (reference ``FixedLengthRecordReader``, the CIFAR-10 binary format)."""

    def __init__(self, record_bytes, header_bytes=0, footer_bytes=0):
        self.record_bytes = record_bytes
        self.header_bytes = header_bytes
        self.footer_bytes = footer_bytes

    def read(self, path):
        with open(path, "rb") as f:
            data = f.read()
        end = len(data) - self.footer_bytes
        pos = self.header_bytes
        while pos + self.record_bytes <= end:
            yield data[pos:pos + self.record_bytes]
            pos += self.record_bytes
