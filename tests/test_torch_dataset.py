"""The port's data pipeline (``bigdl_tpu_torch/dataset/``) against the JAX
reference's (``bigdl_tpu/dataset/``), on the CPU: the same records give
the same bytes and arrays, bit for bit.

- ``synthetic_mnist`` and the idx readers, ``load_mnist``'s strict mode;
- the LeNet pipeline's batches (``mnist_dataset``), with a padded tail;
- ``SampleToMiniBatch``'s three tail modes, ``MiniBatch.slice``,
  ``ToSuperBatch``, ``Prefetch``;
- ``LocalDataSet.shuffle(seed)``: the reference's order;
- ``DeviceFeed`` on the CPU: one item ahead, counted, float64 as float32;
- distributed datasets built over one process, refused over more (A.10(b)).
"""

import gzip
import struct

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import dataset as jds
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.dataset import transformer as jtr
from bigdl_tpu.dataset.minibatch import MiniBatch as JaxMiniBatch
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu_torch.dataset import dataset as tds
from bigdl_tpu_torch.dataset import mnist as tmnist
from bigdl_tpu_torch.dataset import transformer as ttr
from bigdl_tpu_torch.dataset.minibatch import MiniBatch
from bigdl_tpu_torch.dataset.sample import Sample


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.get_input(), w.get_input())
        np.testing.assert_array_equal(g.get_target(), w.get_target())
        assert g.get_input().dtype == w.get_input().dtype
        assert g.real_size == w.real_size and g.size() == w.size()


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_synthetic_mnist_bytes_equal_reference(seed):
    gi, gl = tmnist.synthetic_mnist(300, seed)
    wi, wl = jmnist.synthetic_mnist(300, seed)
    assert gi.tobytes() == wi.tobytes() and gl.tobytes() == wl.tobytes()


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_and_strict_mode(tmp_path, gz):
    images, labels = tmnist.synthetic_mnist(20, 3)
    opener, sfx = (gzip.open, ".gz") if gz else (open, "")
    with opener(tmp_path / f"train-images-idx3-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 20, 28, 28) + images.tobytes())
    with opener(tmp_path / f"train-labels-idx1-ubyte{sfx}", "wb") as f:
        f.write(struct.pack(">II", 2049, 20) + labels.tobytes())
    for mod in (tmnist, jmnist):
        gi, gl = mod.load_mnist(str(tmp_path), training=True, strict=True)
        np.testing.assert_array_equal(gi, images)
        np.testing.assert_array_equal(gl, labels)
        with pytest.raises(FileNotFoundError, match="idx files"):
            mod.load_mnist(str(tmp_path), training=False, strict=True)
    fallback = tmnist.load_mnist(str(tmp_path), training=False,
                                 synthetic_size=10)
    np.testing.assert_array_equal(fallback[0],
                                  jmnist.synthetic_mnist(10, 1)[0])


@pytest.mark.parametrize("training", [True, False])
def test_mnist_pipeline_batches_equal_reference(training):
    kw = dict(training=training, batch_size=64, synthetic_size=150)
    _same_batches(tmnist.mnist_dataset(**kw).data(train=False),
                  jmnist.mnist_dataset(**kw).data(train=False))
    tail = list(tmnist.mnist_dataset(**kw).data(train=False))[-1]
    assert tail.size() == 64 and tail.real_size == 150 - 128
    np.testing.assert_array_equal(tail.get_input()[22:],
                                  np.repeat(tail.get_input()[21:22], 42, 0))


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("tail", [dict(), dict(pad_last=False),
                                  dict(drop_last=True)],
                         ids=["pad_last", "short_tail", "drop_last"])
def test_sample_to_minibatch_tails(tail):
    x, y = _samples(11)
    got = ttr.SampleToMiniBatch(4, **tail)(
        Sample.from_ndarray(a, b) for a, b in zip(x, y))
    want = jtr.SampleToMiniBatch(4, **tail)(
        JaxSample.from_ndarray(a, b) for a, b in zip(x, y))
    _same_batches(got, want)


def test_array_and_func_transformers_equal_reference():
    x, y = _samples(7)
    pairs = list(zip(x, y))
    chain_t = ttr.ArrayToSample() >> ttr.FuncTransformer(
        lambda s: Sample(s.features * 2, s.labels)) \
        >> ttr.SampleToMiniBatch(3)
    chain_j = jtr.ArrayToSample() >> jtr.FuncTransformer(
        lambda s: JaxSample(s.features * 2, s.labels)) \
        >> jtr.SampleToMiniBatch(3)
    assert isinstance(chain_t, ttr.ChainedTransformer)
    _same_batches(chain_t(iter(pairs)), chain_j(iter(pairs)))
    assert list(ttr.Identity()(iter([1, 2]))) == [1, 2]


def test_minibatch_slice_and_superbatch_equal_reference():
    x, y = _samples(10)
    got = MiniBatch.from_samples([Sample(a, b) for a, b in zip(x, y)],
                                 pad_to=12)
    want = JaxMiniBatch.from_samples(
        [JaxSample(a, b) for a, b in zip(x, y)], pad_to=12)
    for off, n in [(0, 4), (8, 4), (10, 2)]:
        _same_batches([got.slice(off, n)], [want.slice(off, n)])
    batches = list(ttr.SampleToMiniBatch(3)(
        Sample(a, b) for a, b in zip(x, y)))
    sbs = list(ttr.ToSuperBatch(3)(iter(batches)))
    jsbs = list(jtr.ToSuperBatch(3)(iter(batches)))
    assert [sb.k for sb in sbs] == [sb.k for sb in jsbs] == [3, 1]
    for g, w in zip(sbs, jsbs):
        np.testing.assert_array_equal(g.input, w.input)
        np.testing.assert_array_equal(g.target, w.target)
        assert g.sizes == w.sizes and g.real_sizes == w.real_sizes
    assert sbs[1].real_sizes == [1] and sbs[0].slice_steps(1, 3).k == 2
    with pytest.raises(ValueError, match="positive integer"):
        ttr.ToSuperBatch(0)


def test_prefetch_keeps_order_and_surfaces_errors():
    assert list(ttr.Prefetch(2)(iter(range(50)))) == list(range(50))

    def broken():
        yield 1
        raise RuntimeError("bad record")

    with pytest.raises(RuntimeError, match="bad record"):
        list(ttr.Prefetch(2)(broken()))
    it = ttr.Prefetch(1)(iter(range(1000)))
    assert next(it) == 0
    it.close()          # an abandoned producer gives up


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_shuffle_order_for_a_seed_equals_reference(seed):
    records = list(range(37))
    t, j = tds.LocalDataSet(records), jds.LocalDataSet(records)
    for _ in range(3):
        t.shuffle(seed)
        j.shuffle(seed)
        assert list(t.data(train=True)) == list(j.data(train=True))
    assert list(t.data(train=False)) == records
    u = tds.DataSet.sample_arrays(*_samples(5))
    assert u.size() == 5 and isinstance(u, tds.LocalDataSet)


def test_device_feed_on_the_cpu():
    x, y = _samples(9)
    ds = tds.DataSet.array([Sample(a.astype(np.float64), b)
                            for a, b in zip(x, y)]) \
        >> ttr.SampleToMiniBatch(4)
    feed = ttr.DeviceFeed("cpu")
    before = ttr.DeviceFeed.copies
    seen = 0
    for batch, (bx, by) in feed(ds.data(train=False)):
        # the next batch's two copies are issued before this one is
        # consumed
        assert ttr.DeviceFeed.copies - before == 2 * min(seen + 2, 3)
        assert bx.dtype == torch.float32 and by.dtype == torch.int32
        np.testing.assert_array_equal(bx.numpy(),
                                      batch.get_input().astype(np.float32))
        seen += 1
    assert seen == 3 and ttr.DeviceFeed.copies - before == 6


def test_distributed_datasets_are_refused():
    """Over one process the factories build a ``DistributedDataSet`` (ROADMAP
    queue A.10 is ported; ``test_torch_distri_optimizer.py`` holds its
    orders against the reference's); over more than one process it is
    refused, naming ROADMAP queue A.10(b)."""
    for make in (lambda: tds.DataSet.array([1, 2], distributed=True),
                 lambda: tds.DataSet.sample_arrays([1], [0],
                                                   distributed=True),
                 lambda: tmnist.mnist_dataset(distributed=True,
                                              synthetic_size=8)):
        assert isinstance(make(), tds.DistributedDataSet)
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue A.10\(b\)"):
        tds.DistributedDataSet([1, 2], process_index=0, process_count=2)
