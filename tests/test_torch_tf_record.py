"""The port's TFRecord framing and tf.Example codec
(``bigdl_tpu_torch/dataset/record_file.py``, ``interop/tf_record.py``)
against the JAX reference's (``bigdl_tpu/dataset/record_file.py``,
``visualization/tensorboard.py``'s CRC, ``interop/tf_record.py``), on the
CPU, as the reference's ``tests/test_interop.py`` holds its own.

Each package reads the other's files, and for the same Examples both
write the same bytes; the CRC32C of known vectors (RFC 3720's) equals the
reference's; a flipped byte or a cut file raises ``IOError``.
"""

import numpy as np
import pytest

from bigdl_tpu.dataset import record_file as jrf
from bigdl_tpu.interop import tf_record as jtr
from bigdl_tpu.visualization import tensorboard as jtb
from bigdl_tpu_torch import interop
from bigdl_tpu_torch.dataset import record_file as trf
from bigdl_tpu_torch.interop import tf_record as ttr


def _examples(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image/raw": rng.integers(0, 256, 48, dtype=np.uint8)
             .tobytes(),
             "image/class/label": np.asarray([int(rng.integers(0, 10))]),
             "vec": rng.standard_normal(3).astype(np.float32),
             "tokens": [b"a", b"bc", bytes(rng.integers(0, 256, 4,
                                                        dtype=np.uint8))]}
            for _ in range(n)]


def _write(mod, path, feats):
    with mod.TFRecordWriter(path) as w:
        for f in feats:
            w.write_example(f)
    with open(path, "rb") as f:
        return f.read()


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_exports_match_the_reference():
    for name in ("parse_example", "build_example", "tf_record_iterator",
                 "read_tf_examples", "TFRecordWriter",
                 "FixedLengthRecordReader"):
        assert getattr(interop, name) is getattr(ttr, name)
        assert name in interop.__all__


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(32),
                                  bytes(range(32)), bytes(range(32))[::-1],
                                  bytes(range(256)) * 3])
def test_crc32c_and_mask_equal_the_references(data):
    assert trf.crc32c(data) == jtb._crc32c_py(data) == jtb.crc32c(data)
    assert trf.masked_crc(data) == jtb.masked_crc(data)


def test_crc32c_known_vectors():
    # RFC 3720 B.4 and the common check value
    assert trf.crc32c(b"123456789") == 0xE3069283
    assert trf.crc32c(bytes(32)) == 0x8A9136AA
    assert trf.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert trf.crc32c(bytes(range(32))) == 0x46DD794E


def test_both_packages_write_the_same_bytes(tmp_path):
    feats = _examples()
    mine = _write(ttr, tmp_path / "port.tfrecord", feats)
    theirs = _write(jtr, tmp_path / "ref.tfrecord", feats)
    assert mine == theirs
    assert [ttr.build_example(f) for f in feats] == \
        [jtr.build_example(f) for f in feats]


def test_each_reads_the_others_file(tmp_path):
    feats = _examples(seed=1)
    _write(jtr, tmp_path / "ref.tfrecord", feats)
    _write(ttr, tmp_path / "port.tfrecord", feats)
    for path in ("ref.tfrecord", "port.tfrecord"):
        got = list(ttr.read_tf_examples(tmp_path / path))
        want = list(jtr.read_tf_examples(tmp_path / path))
        assert len(got) == len(want) == len(feats)
        for g, w in zip(got, want):
            _same(g, w)
        assert list(ttr.tf_record_iterator(tmp_path / path)) == \
            list(jtr.tf_record_iterator(tmp_path / path))
    first = next(ttr.read_tf_examples(tmp_path / "ref.tfrecord"))
    assert first["image/raw"] == [feats[0]["image/raw"]]
    np.testing.assert_array_equal(first["vec"], feats[0]["vec"])


def test_framing_round_trip_matches_the_reference(tmp_path):
    blobs = [b"", b"x", bytes(range(200)) * 7]
    with open(tmp_path / "a", "wb") as f:
        for b in blobs:
            trf.write_framed(f, b)
    with open(tmp_path / "b", "wb") as f:
        for b in blobs:
            jrf.write_framed(f, b)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    with open(tmp_path / "a", "rb") as f:
        assert list(trf.read_framed(f)) == blobs


@pytest.mark.parametrize("where", ["length", "header_crc", "payload",
                                   "payload_crc"])
def test_a_flipped_byte_raises(tmp_path, where):
    data = bytearray(_write(ttr, tmp_path / "ok", _examples(2)))
    first = len(ttr.build_example(_examples(2)[0]))
    pos = {"length": 0, "header_crc": 9, "payload": 12 + first // 2,
           "payload_crc": 12 + first + 1}[where]
    data[pos] ^= 0x10
    (tmp_path / "bad").write_bytes(bytes(data))
    for mod in (ttr, jtr):
        with pytest.raises(IOError):
            list(mod.tf_record_iterator(tmp_path / "bad"))


@pytest.mark.parametrize("cut", [3, 10, 30, 1])
def test_a_cut_file_raises(tmp_path, cut):
    data = _write(ttr, tmp_path / "ok", _examples(2))
    (tmp_path / "cut").write_bytes(data[:len(data) - cut] if cut > 1
                                   else data[:4])
    for mod in (ttr, jtr):
        with pytest.raises(IOError):
            list(mod.tf_record_iterator(tmp_path / "cut"))


def test_fixed_length_record_reader(tmp_path):
    """The CIFAR-10 binary layout: a label byte and 3 x 4 x 4 pixels a
    record, after a header and before a footer."""
    rng = np.random.default_rng(2)
    recs = [bytes([i]) + rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
            for i in range(6)]
    path = tmp_path / "data.bin"
    path.write_bytes(b"HDR" + b"".join(recs) + b"FOOTER!")
    for hdr, ftr in ((3, 7), (3, 0), (0, 7)):
        got = list(ttr.FixedLengthRecordReader(49, hdr, ftr).read(path))
        want = list(jtr.FixedLengthRecordReader(49, hdr, ftr).read(path))
        assert got == want
    assert list(ttr.FixedLengthRecordReader(49, 3, 7).read(path)) == recs
    assert len(list(ttr.FixedLengthRecordReader(50, 3, 7).read(path))) == 5


def test_parse_example_types_and_empty_features():
    feats = {"f": np.asarray([], np.float32), "i": np.asarray([-5, 2 ** 40]),
             "b": [b"", b"z"]}
    blob = ttr.build_example(feats)
    assert blob == jtr.build_example(feats)
    _same(ttr.parse_example(blob), jtr.parse_example(blob))
    got = ttr.parse_example(blob)
    assert got["i"].dtype == np.int64 and got["i"].tolist() == [-5, 2 ** 40]
