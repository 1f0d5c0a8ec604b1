"""MNIST loading and the grey-image transformer chain (the port's copy of
``bigdl_tpu/dataset/mnist.py``: idx readers, ``synthetic_mnist``,
``load_mnist``, ``BytesToGreyImg`` -> ``GreyImgNormalizer`` ->
``GreyImgToSample``, and ``mnist_dataset``, the LeNet input pipeline of
reference ``models/lenet/Train.scala:61``).

Nothing downloads: without idx files under ``folder`` the pipeline builds
the reference's procedural digits, byte for byte the same for a seed
(``strict=True`` refuses that fallback).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch, Transformer

TRAIN_MEAN, TRAIN_STD = 0.13066047740239506, 0.3081078


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), dtype=np.uint8)


def synthetic_mnist(n, seed=0):
    """Deterministic digit-like data: each class is a distinct
    low-frequency pattern plus noise (uint8 images [n, 28, 28], uint8
    labels [n])."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.uint8)
    xs = np.linspace(-1, 1, 28)
    xx, yy = np.meshgrid(xs, xs)
    protos = np.stack([
        np.sin(3 * xx * (1 + 0.3 * k)) * np.cos(3 * yy * (1 + 0.2 * k))
        + 0.5 * np.sin((k + 1) * (xx + yy))
        for k in range(10)
    ])
    protos = (protos - protos.min()) / (protos.max() - protos.min())
    images = protos[labels] + 0.15 * rng.standard_normal((n, 28, 28))
    images = np.clip(images, 0, 1) * 255.0
    return images.astype(np.uint8), labels


def load_mnist(folder=None, training=True, synthetic_size=2048,
               strict=False):
    """(images uint8 [N, 28, 28], labels uint8 [N]) from the idx files
    under ``folder`` (plain or ``.gz``), else the synthetic digits (seed 0
    for training, 1 for test); ``strict=True`` raises instead."""
    if folder:
        stem = "train" if training else "t10k"
        for suffix in ("", ".gz"):
            ip = os.path.join(folder, f"{stem}-images-idx3-ubyte{suffix}")
            lp = os.path.join(folder, f"{stem}-labels-idx1-ubyte{suffix}")
            if os.path.exists(ip) and os.path.exists(lp):
                return _read_idx_images(ip), _read_idx_labels(lp)
        if strict:
            raise FileNotFoundError(
                f"no {stem} idx files under {folder!r} — refusing the "
                "synthetic fallback in strict mode")
    return synthetic_mnist(synthetic_size, seed=0 if training else 1)


class BytesToGreyImg(Transformer):
    """(image uint8 [28, 28], label) -> Sample(float32 [28, 28] / 255,
    int32 label)."""

    def apply(self, iterator):
        for img, label in iterator:
            yield Sample(np.asarray(img, dtype=np.float32) / 255.0,
                         np.int32(label))


class GreyImgNormalizer(Transformer):
    def __init__(self, mean=TRAIN_MEAN, std=TRAIN_STD):
        self.mean, self.std = mean, std

    def apply(self, iterator):
        for sample in iterator:
            yield Sample((sample.features - self.mean) / self.std,
                         sample.labels)


class GreyImgToSample(Transformer):
    """Add the channel axis: [28, 28] -> [1, 28, 28] (NCHW)."""

    def apply(self, iterator):
        for sample in iterator:
            yield Sample(sample.features[None, ...], sample.labels)


def mnist_dataset(folder=None, training=True, batch_size=128,
                  distributed=False, synthetic_size=2048):
    """The LeNet input pipeline: records -> grey images -> normalised ->
    NCHW samples -> MiniBatches of ``batch_size``."""
    images, labels = load_mnist(folder, training, synthetic_size)
    ds = DataSet.array(list(zip(images, labels)), distributed)
    return ds >> BytesToGreyImg() >> GreyImgNormalizer() \
        >> GreyImgToSample() >> SampleToMiniBatch(batch_size)
