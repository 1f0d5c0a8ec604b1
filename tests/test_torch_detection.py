"""The port's detection layers (``bigdl_tpu_torch/nn/detection.py``)
against the reference's (``bigdl_tpu/nn/detection.py``) on the CPU.

- The reference's 15 ``tests/test_detection.py`` cases, each run through
  both packages: the analytic values, and the port's output equal to the
  reference's (boxes within 1e-5 of their largest magnitude: ``exp`` of
  two libraries; labels, scores and the kept set exactly).
- Seeded random cases of every layer, ``Proposal`` in both modes and both
  ``DetectionOutputSSD`` branches (``nms_topk`` below and above the
  priors).
- Ties: equal scores fed straight in, so the inputs are bit-identical in
  both packages, to ``nms_keep``, ``Nms``, ``Proposal`` and
  ``DetectionOutputFrcnn``: the order of the kept rows, the -inf
  proposals and the padded rows is held exactly (``DetectionOutputSSD``'s
  tie case, ``conf_post_process=False``, is in
  ``tests/test_torch_detection_slice.py``).
- ``RoiPooling`` makes no tensor larger than its RoIs' (R, C, H, W) map,
  and the NMS sweep reads nothing back to the host (every aten operation
  of the call recorded).
- ``Nms.nms`` on arrays and ``Anchor.generate_anchors`` default to the
  card, as every entry point does.

The whole slice and a detection model file across the packages are in
``tests/test_torch_detection_slice.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.table import T
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn import detection as td

REL = 1e-5
CPU = "cpu"


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return T(*[jnp.asarray(a) for a in arrays])


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all() and (got[~fin] == want[~fin])\
        .all(), what
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-6)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=rel * scale,
                               err_msg=what)


def _rows_equal(got, want, what):
    """Detection rows: labels and scores exactly, boxes within REL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got[..., 0], want[..., 0], err_msg=what)
    np.testing.assert_array_equal(got[..., 1], want[..., 1], err_msg=what)
    _close(got[..., 2:], want[..., 2:], what)


def _boxes(rng, n, scale=100.0):
    xy = rng.random((n, 2)) * scale
    wh = rng.random((n, 2)) * scale * 0.4 + 1.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _priors(rng, p):
    b = _boxes(rng, p, 1.0)
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), p)
    return np.stack([b.reshape(-1), var])[None]


# ------------------------------------------- the reference's 15 test cases
def test_classic_basic_anchors():
    want = np.array([
        [-84, -40, 99, 55], [-176, -88, 191, 103], [-360, -184, 375, 199],
        [-56, -56, 71, 71], [-120, -120, 135, 135], [-248, -248, 263, 263],
        [-36, -80, 51, 95], [-80, -168, 95, 183], [-168, -344, 183, 359],
    ], np.float32)
    a = tnn.Anchor([0.5, 1.0, 2.0], [8.0, 16.0, 32.0])
    np.testing.assert_array_equal(a.basic_anchors.numpy(), want)
    np.testing.assert_array_equal(
        a.basic_anchors.numpy(),
        np.asarray(jnn.Anchor([0.5, 1.0, 2.0], [8.0, 16.0, 32.0])
                   .basic_anchors))


def test_grid_shifts():
    grid = tnn.Anchor([1.0], [8.0]).generate_anchors(3, 2, feat_stride=16.0,
                                                     device=CPU)
    assert tuple(grid.shape) == (6, 4)
    np.testing.assert_array_equal((grid[1] - grid[0]).numpy(), [16, 0, 16, 0])
    np.testing.assert_array_equal((grid[3] - grid[0]).numpy(), [0, 16, 0, 16])
    np.testing.assert_array_equal(grid.numpy(), np.asarray(
        jnn.Anchor([1.0], [8.0]).generate_anchors(3, 2, feat_stride=16.0)))


def test_nms_suppresses_overlaps():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    kept = tnn.Nms().nms(*_t(scores, boxes), thresh=0.5)
    np.testing.assert_array_equal(kept, [0, 2])
    np.testing.assert_array_equal(kept, jnn.Nms().nms(scores, boxes, 0.5))
    assert kept.dtype == np.int32


def test_nms_keeps_below_threshold():
    boxes = np.array([[0, 0, 10, 10], [8, 8, 18, 18]], np.float32)
    scores = np.array([0.5, 0.9], np.float32)
    kept = tnn.Nms().nms(*_t(scores, boxes), thresh=0.9)
    np.testing.assert_array_equal(kept, [1, 0])
    assert tnn.Nms().nms(torch.zeros(0), torch.zeros(0, 4), 0.5).size == 0


def test_host_helpers_default_to_the_card():
    """``Nms.nms`` on numpy arrays and ``generate_anchors`` place their
    tensors on the card unless ``device="cpu"``: without CUDA they raise,
    as every entry point does, and with ``device="cpu"`` they run."""
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.Nms().nms(scores, boxes, thresh=0.5)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.Anchor([1.0], [8.0]).generate_anchors(3, 2)
    np.testing.assert_array_equal(
        tnn.Nms().nms(scores, boxes, thresh=0.5, device=CPU),
        jnn.Nms().nms(scores, boxes, 0.5))
    assert tnn.Anchor([1.0], [8.0]).generate_anchors(
        3, 2, device=CPU).device.type == "cpu"


def test_iou_matrix_analytic():
    a = torch.tensor([[0, 0, 9, 9]], dtype=torch.float32)
    b = torch.tensor([[0, 0, 9, 9], [5, 0, 14, 9]], dtype=torch.float32)
    m = tnn.iou_matrix(a, b).numpy()
    assert m[0, 0] == pytest.approx(1.0)
    assert m[0, 1] == pytest.approx(50 / 150)
    np.testing.assert_array_equal(m, np.asarray(jnn.iou_matrix(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))


def test_zero_deltas_identity():
    out = tnn.bbox_transform_inv(torch.tensor([[10.0, 20, 30, 40]]),
                                 torch.zeros(1, 4))
    np.testing.assert_allclose(out.numpy(), [[10, 20, 30, 40]], atol=1e-5)


def test_clip():
    out = tnn.clip_boxes(torch.tensor([[-5.0, -5, 200, 90]]), 100.0, 150.0)
    np.testing.assert_array_equal(out.numpy(), [[0, 0, 149, 90]])
    out = tnn.clip_boxes(torch.tensor([[-5.0, -5, 200, 90]]),
                         torch.tensor(100.0), torch.tensor(150.0))
    np.testing.assert_array_equal(out.numpy(), [[0, 0, 149, 90]])


def test_ssd_decode_zero_deltas():
    out = tnn.decode_boxes(torch.tensor([[0.1, 0.1, 0.3, 0.5]]),
                           torch.full((1, 4), 0.1), torch.zeros(1, 4))
    np.testing.assert_allclose(out.numpy(), [[0.1, 0.1, 0.3, 0.5]],
                               atol=1e-6)


def test_prior_box_shape_and_first_box():
    kw = dict(min_sizes=[30.0], max_sizes=[60.0], aspect_ratios=[2.0],
              img_size=300, step=8.0, variances=[0.1, 0.1, 0.2, 0.2],
              offset=0.5)
    pb = tnn.PriorBox(**kw)
    x = np.zeros((1, 256, 4, 4), np.float32)
    out = pb(*_t(x))
    assert pb.num_priors == 4
    assert tuple(out.shape) == (1, 2, 4 * 4 * 4 * 4)
    boxes = out[0, 0].reshape(-1, 4).numpy()
    c, half = 0.5 * 8.0 / 300.0, 0.5 * 30.0 / 300.0
    np.testing.assert_allclose(boxes[0], [c - half, c - half, c + half,
                                          c + half], atol=1e-6)
    np.testing.assert_allclose(out[0, 1].reshape(-1, 4)[0].numpy(),
                               [0.1, 0.1, 0.2, 0.2])
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jnn.PriorBox(**kw).forward(jnp.asarray(x))))


def test_proposal_outputs_valid_rois():
    rng = np.random.RandomState(0)
    a, h, w = 9, 6, 8
    scores = rng.rand(1, 2 * a, h, w).astype(np.float32)
    deltas = ((rng.rand(1, 4 * a, h, w) - 0.5) * 0.2).astype(np.float32)
    im_info = np.array([[96.0, 128.0, 1.0, 1.0]], np.float32)
    args = (60, 10, [0.5, 1.0, 2.0], [4.0, 8.0, 16.0])
    rois, s = tnn.Proposal(*args)(_t(scores, deltas, im_info))
    assert tuple(rois.shape) == (10, 5)
    valid = torch.isfinite(s).numpy()
    r = rois.numpy()[valid]
    assert (r[:, 1] >= 0).all() and (r[:, 3] <= 127).all()
    assert (r[:, 2] >= 0).all() and (r[:, 4] <= 95).all()
    assert (np.diff(s.numpy()[valid]) <= 1e-6).all()
    want = jnn.Proposal(*args).forward(_j(scores, deltas, im_info))
    _close(rois.numpy(), np.asarray(want[1]), "rois")
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[2]))


def _pool(data, rois, *args):
    got = tnn.RoiPooling(*args)(_t(data, rois)).numpy()
    want = np.asarray(jnn.RoiPooling(*args).forward(_j(data, rois)))
    np.testing.assert_array_equal(got, want)
    return got


def test_roi_pooling_analytic_max():
    data = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 0, 1, 3]], np.float32)
    out = _pool(data, rois, 2, 2, 1.0)
    np.testing.assert_array_equal(out[0, 0], [[4, 5], [12, 13]])


def test_roi_pooling_full_image():
    data = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    np.testing.assert_array_equal(_pool(data, rois, 2, 2, 1.0)[0, 0],
                                  [[5, 7], [13, 15]])


def test_roi_pooling_spatial_scale_and_batch_index():
    data = np.stack([np.zeros((1, 4, 4), np.float32),
                     np.arange(16, dtype=np.float32).reshape(1, 4, 4)])
    rois = np.array([[1, 0, 0, 6, 6]], np.float32)
    assert _pool(data, rois, 1, 1, 0.5)[0, 0, 0, 0] == 15.0


def test_detection_output_ssd_single_prior_decode():
    p = 2
    priors = np.zeros((1, 2, p * 4), np.float32)
    priors[0, 0] = [0.1, 0.1, 0.3, 0.3, 0.6, 0.6, 0.9, 0.9]
    priors[0, 1] = 0.1
    loc = np.zeros((1, p * 4), np.float32)
    conf = np.array([[[0.0, 5.0, 0.0], [5.0, 0.0, 0.0]]],
                    np.float32).reshape(1, -1)
    kw = dict(n_classes=3, keep_top_k=4, conf_thresh=0.2)
    out = tnn.DetectionOutputSSD(**kw)(_t(loc, conf, priors)).numpy()
    assert out.shape == (1, 4, 6)
    assert out[0, 0, 0] == 1.0 and out[0, 0, 1] > 0.9
    np.testing.assert_allclose(out[0, 0, 2:], [0.1, 0.1, 0.3, 0.3],
                               atol=1e-5)
    assert (out[0][out[0][:, 1] == 0][:, 0] == -1).all()
    _rows_equal(out, jnn.DetectionOutputSSD(**kw).forward(
        _j(loc, conf, priors)), "ssd")


def test_detection_output_frcnn_basic():
    rois = np.array([[0, 10, 10, 30, 30], [0, 50, 50, 80, 80]], np.float32)
    cls_prob = np.array([[0.1, 0.8, 0.1], [0.1, 0.1, 0.8]], np.float32)
    bbox_pred = np.zeros((2, 12), np.float32)
    im_info = np.array([[100.0, 100.0, 1.0, 1.0]], np.float32)
    inputs = (cls_prob, bbox_pred, rois, im_info)
    out = tnn.DetectionOutputFrcnn(n_classes=3, keep_top_k=5)(
        _t(*inputs)).numpy()
    assert out.shape == (5, 6)
    assert set(out[out[:, 1] > 0][:, 0].tolist()) == {1.0, 2.0}
    np.testing.assert_allclose(out[out[:, 0] == 1.0][0][2:],
                               [10, 10, 30, 30], atol=1e-4)
    _rows_equal(out, jnn.DetectionOutputFrcnn(n_classes=3, keep_top_k=5)
                .forward(_j(*inputs)), "frcnn")


# ------------------------------------------------------ seeded random cases
@pytest.mark.parametrize("normalized", [False, True])
def test_nms_keep_batched_rows_match_reference_one_by_one(normalized):
    rng = np.random.default_rng(3)
    boxes = np.stack([_boxes(rng, 40, 1.0 if normalized else 100.0)
                      for _ in range(6)])
    scores = rng.random((6, 40)).astype(np.float32)
    order, keep = tnn.nms_keep(*_t(boxes, scores), 0.4, normalized)
    for r in range(6):
        jo, jk = jnn.nms_keep(jnp.asarray(boxes[r]), jnp.asarray(scores[r]),
                              0.4, normalized)
        np.testing.assert_array_equal(order[r].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(keep[r].numpy(), np.asarray(jk))


@pytest.mark.parametrize("training", [False, True])
def test_proposal_matches_reference(training):
    rng = np.random.default_rng(4)
    a, h, w = 9, 7, 9
    scores = rng.random((1, 2 * a, h, w)).astype(np.float32)
    deltas = (rng.standard_normal((1, 4 * a, h, w)) * 0.3).astype(np.float32)
    im_info = np.array([[112.0, 144.0, 1.5, 1.25]], np.float32)
    args = (200, 30, [0.5, 1.0, 2.0], [2.0, 4.0, 8.0])
    kw = dict(rpn_pre_nms_topn_train=300, rpn_post_nms_topn_train=50,
              min_size=8.0, nms_thresh=0.6)
    port = tnn.Proposal(*args, **kw).train(training)
    rois, s = port(_t(scores, deltas, im_info))
    want, _ = jnn.Proposal(*args, **kw).apply((), (), _j(scores, deltas,
                                                         im_info),
                                              training=training)
    assert tuple(rois.shape) == ((50, 5) if training else (30, 5))
    _close(rois.numpy(), np.asarray(want[1]), "rois")
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[2]))


def test_roi_pooling_matches_reference():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    rois = np.array([[0, 1, 2, 30, 40], [1, 0, 0, 50, 50],
                     [0, 20, 20, 21, 21], [1, 5.5, 6.5, 17.5, 33.0],
                     [0, 60, 60, 70, 70]], np.float32)
    out = _pool(data, rois, 3, 2, 0.25)
    assert out.shape == (5, 3, 2, 3)
    assert (out[4] == 0).all()                  # outside the map: empty bins


@pytest.mark.parametrize("nms_topk", [400, 25])
def test_detection_output_ssd_matches_reference(nms_topk):
    rng = np.random.default_rng(6)
    p, c, n = 60, 3, 3
    prior = _priors(rng, p)
    loc = (rng.standard_normal((n, p * 4)) * 0.5).astype(np.float32)
    conf = (rng.standard_normal((n, p * c)) * 2).astype(np.float32)
    kw = dict(n_classes=c, nms_topk=nms_topk, keep_top_k=70,
              conf_thresh=0.1)
    port = tnn.DetectionOutputSSD(**kw)
    got = port(_t(loc, conf, prior))
    want = jnn.DetectionOutputSSD(**kw).forward(_j(loc, conf, prior))
    assert tuple(got.shape) == (n, 70, 6)
    np.testing.assert_array_equal(got[..., 0].numpy(),
                                  np.asarray(want)[..., 0])
    _close(got[..., 1].numpy(), np.asarray(want)[..., 1], "scores")
    _close(got[..., 2:].numpy(), np.asarray(want)[..., 2:], "boxes")


def test_detection_output_frcnn_matches_reference():
    rng = np.random.default_rng(7)
    r, c = 40, 3
    rois = np.concatenate([np.zeros((r, 1), np.float32), _boxes(rng, r)], 1)
    e = np.exp(rng.standard_normal((r, c)))
    cls_prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    bbox = (rng.standard_normal((r, 4 * c)) * 0.1).astype(np.float32)
    im_info = np.array([[90.0, 110.0, 1.0, 1.0]], np.float32)
    for inputs in ((cls_prob, bbox, rois, im_info), (cls_prob, bbox, rois)):
        got = tnn.DetectionOutputFrcnn(c, keep_top_k=50)(_t(*inputs))
        want = jnn.DetectionOutputFrcnn(c, keep_top_k=50).forward(
            _j(*inputs))
        np.testing.assert_array_equal(got[:, :2].numpy(),
                                      np.asarray(want)[:, :2])
        _close(got[:, 2:].numpy(), np.asarray(want)[:, 2:], "boxes")


# ------------------------------------------------------------------- ties
def test_nms_ties_keep_the_lower_index_first():
    boxes = np.array([[0, 0, 10, 10], [50, 50, 60, 60], [1, 1, 11, 11],
                      [51, 51, 61, 61], [100, 0, 110, 10]], np.float32)
    scores = np.full(5, 0.5, np.float32)
    order, keep = tnn.nms_keep(*_t(boxes, scores), 0.5)
    np.testing.assert_array_equal(order.numpy(), [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(keep.numpy(), [1, 1, 0, 0, 1])
    jo, jk = jnn.nms_keep(jnp.asarray(boxes), jnp.asarray(scores), 0.5)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tnn.Nms().nms(*_t(scores, boxes), 0.5),
                                  [0, 1, 4])


def test_proposal_ties_and_minus_inf_rows_in_index_order():
    """Every object score equal, some boxes below min_size (-inf): the
    kept rows, then the suppressed ones, in the reference's order."""
    a, h, w = 3, 4, 5
    scores = np.full((1, 2 * a, h, w), 0.5, np.float32)
    rng = np.random.default_rng(8)
    deltas = (rng.standard_normal((1, 4 * a, h, w)) * 0.8).astype(np.float32)
    im_info = np.array([[64.0, 80.0, 1.0, 1.0]], np.float32)
    args = (40, 40, [0.5, 1.0, 2.0], [1.0])
    kw = dict(min_size=12.0, nms_thresh=0.5)
    rois, s = tnn.Proposal(*args, **kw).eval()(_t(scores, deltas, im_info))
    want, _ = jnn.Proposal(*args, **kw).apply((), (), _j(scores, deltas,
                                                         im_info))
    assert np.isinf(s.numpy()).any() and np.isfinite(s.numpy()).any()
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[2]))
    _close(rois.numpy(), np.asarray(want[1]), "rois")


def test_detection_output_frcnn_ties_and_padding():
    rng = np.random.default_rng(10)
    r, c = 25, 3
    rois = np.concatenate([np.zeros((r, 1), np.float32), _boxes(rng, r)], 1)
    cls_prob = np.full((r, c), 0.25, np.float32)
    cls_prob[::4, 1] = 0.02                       # below conf_thresh
    bbox = np.zeros((r, 4 * c), np.float32)
    kw = dict(n_classes=c, keep_top_k=90, nms_thresh=0.3)
    got = tnn.DetectionOutputFrcnn(**kw)(_t(cls_prob, bbox, rois)).numpy()
    want = np.asarray(jnn.DetectionOutputFrcnn(**kw).forward(
        _j(cls_prob, bbox, rois)))
    assert (got[:, 0] == -1).any()
    _rows_equal(got, want, "frcnn ties")


# -------------------------------------------------- memory and host reads
class _Ops(TorchDispatchMode):
    """Every aten operation of a call: its name and its outputs' sizes."""

    def __init__(self):
        super().__init__()
        self.names, self.largest = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.names.append(str(func.overloadpacket))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_roi_pooling_makes_nothing_larger_than_its_rois_maps():
    rng = np.random.default_rng(11)
    r, c, h, w = 20, 16, 19, 25
    data = torch.from_numpy(rng.standard_normal((1, c, h, w))
                            .astype(np.float32))
    rois = torch.from_numpy(np.concatenate(
        [np.zeros((r, 1), np.float32), _boxes(rng, r, 350.0)], 1))
    with _Ops() as ops:
        out = tnn.RoiPooling(7, 7, 1.0 / 16)([data, rois])
    assert tuple(out.shape) == (r, c, 7, 7)
    assert ops.largest <= r * c * h * w
    # the reference's broadcast would be 49 times that
    assert r * c * 7 * 7 * h * w == 49 * r * c * h * w


def test_nms_sweep_reads_nothing_back():
    rng = np.random.default_rng(12)
    boxes = torch.from_numpy(np.stack([_boxes(rng, 50) for _ in range(4)]))
    scores = torch.from_numpy(rng.random((4, 50)).astype(np.float32))
    td.reset_sweep_counts()
    with _Ops() as ops:
        tnn.nms_keep(boxes, scores, 0.5)
    assert td.SWEEP == {"calls": 1, "steps": 50, "launches": 100}
    reads = {"_local_scalar_dense", "item", "is_nonzero", "equal",
             "allclose", "nonzero"}
    assert not reads & set(n.split(".")[-1] for n in ops.names)
