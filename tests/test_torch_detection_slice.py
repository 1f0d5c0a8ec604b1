"""The whole detection slice of the port against the reference on the
CPU, a detection model file across the two packages, and
``DetectionOutputSSD``'s ties.

- A narrow SSD (two source maps) and a narrow Faster R-CNN, built from
  ``chip_smoke``'s builders (``ssd_build``, ``frcnn_build``: the
  ``detect`` phase's own) in both packages, the port's weights carried
  from the reference's seeded params by ``convert``, give the same
  detection rows (labels exactly; scores and boxes within 1e-5 of their
  largest magnitude), their heads and RoIs the same values.
- A small RPN (``chip_smoke.rpn_train_model``: conv5 and the RPN)
  through both packages' ``make_train_step`` with ``SGD(0.01, momentum
  0.9)`` and ``chip_smoke.rpn_criterion`` (``ParallelCriterion`` of
  ``SoftmaxWithCriterion(ignore_label=-1)`` and
  ``SmoothL1CriterionWithWeights(sigma=3)``) on seeded anchor targets
  gives the same losses for 3 steps (1e-5 relative), falling.
- A ``Sequential`` of a narrow SSD stage, ``NormalizeScale``, its heads, a
  ``PriorBox`` without flip and every detection head, written by the
  port, loads in the reference, whose layers give the port's outputs;
  the reference's file of it loads back in the port with the same
  classes, attributes and outputs bit for bit.
- Equal confidences fed straight into ``DetectionOutputSSD``
  (``conf_post_process=False``, so the inputs are bit-identical), both
  ``nms_topk`` branches: its rows, the padding included, in the
  reference's order exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import chip_smoke as cs
from bigdl_tpu.optim import methods as jmethods
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu.utils import serializer as jser
from bigdl_tpu.utils.table import T
from bigdl_tpu_torch import convert, optim
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.module import init_state_dict
from bigdl_tpu_torch.utils.serializer import load_module, save_module

REL = 1e-5
CPU = "cpu"


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all() and (got[~fin] == want[~fin])\
        .all(), what
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-6)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=REL * scale,
                               err_msg=what)


def _rows_equal(got, want, what):
    """Detection rows: labels and scores exactly, boxes within REL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got[..., 0], want[..., 0], err_msg=what)
    np.testing.assert_array_equal(got[..., 1], want[..., 1], err_msg=what)
    _close(got[..., 2:], want[..., 2:], what)


SSD_NARROW = {
    "image": 32, "classes": 3, "norm_scale": 20.0,
    "stages": [[("conv", 3, 8), ("pool", 2, 2, 0), ("conv", 8, 8)],
               [("pool", 2, 2, 0), ("conv", 8, 16),
                ("conv", 16, 16, 1, 1, 0)]],
    "priors": [(4.0, 8.0, [2.0], 2.0), (8.0, 16.0, [2.0, 3.0], 4.0)],
    "detection": dict(n_classes=3, nms_thresh=0.45, nms_topk=40,
                      keep_top_k=30, conf_thresh=0.01),
}
FRCNN_NARROW = {
    "image": (64, 96), "classes": 3,
    "trunk": [("conv", 3, 4), ("pool", 2, 2, 0), ("conv", 4, 8),
              ("pool", 2, 2, 0), ("conv", 8, 8), ("pool", 2, 2, 0),
              ("conv", 8, 8)],
    "conv5": [("pool", 2, 2, 0), ("conv", 8, 8)],
    "rpn": 8, "ratios": [0.5, 1.0, 2.0], "scales": [2.0, 4.0],
    "proposal": dict(pre_nms_topn=40, post_nms_topn=12, nms_thresh=0.7,
                     min_size=4.0),
    "pooled": 3, "spatial_scale": 1.0 / 16, "fc": 16,
    "detection": dict(n_classes=3, nms_thresh=0.3, conf_thresh=0.05,
                      keep_top_k=20),
}


@pytest.fixture(autouse=True)
def _keep_library_calls():
    """Leave ``SpatialConvolution.library_calls``, a process-wide counter
    that other test files read, as each test found it."""
    saved = tnn.SpatialConvolution.library_calls.copy()
    yield
    tnn.SpatialConvolution.library_calls.clear()
    tnn.SpatialConvolution.library_calls.update(saved)


class _Ref:
    """A builder's reference modules run on the fly: each one's params
    drawn by its ``setup`` at its first input, and carried into the port's
    module of the same place by ``convert``."""

    def __init__(self, ref, port, seed):
        self.ref, self.port = ref, port
        self.key = jax.random.PRNGKey(seed)
        self.params = {}

    def __call__(self, name, x, i=None):
        m = self.ref[name] if i is None else self.ref[name][i]
        if (name, i) not in self.params:
            self.key, sub = jax.random.split(self.key)
            spec = jax.tree_util.tree_map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), x)
            p, s = m.setup(sub, spec)
            self.params[(name, i)] = (p, s)
            tm = self.port[name] if i is None else self.port[name][i]
            sd = convert.module_params_from_jax(
                tm, jax.tree_util.tree_map(np.asarray, p),
                jax.tree_util.tree_map(np.asarray, s))
            if sd:
                tm.load_state_dict(sd)
        p, s = self.params[(name, i)]
        return m.apply(p, s, x, training=False)[0]


def _ref_ssd(run, x):
    n = x.shape[0]
    locs, confs, priors = [], [], []
    h = x
    for i in range(len(SSD_NARROW["stages"])):
        h = run("stages", h, i)
        src = run("norm", h) if i == 0 else h
        locs.append(jnp.transpose(run("loc", src, i), (0, 2, 3, 1))
                    .reshape(n, -1))
        confs.append(jnp.transpose(run("conf", src, i), (0, 2, 3, 1))
                     .reshape(n, -1))
        priors.append(run("priors", src, i))
    return (jnp.concatenate(locs, 1), jnp.concatenate(confs, 1),
            jnp.concatenate(priors, 2))


def test_narrow_ssd_gives_the_references_detections():
    ref = cs.ssd_build(jnn, SSD_NARROW)
    port = cs.ssd_build(tnn, SSD_NARROW, device=CPU)
    run = _Ref(ref, port, 13)
    x = np.random.default_rng(13).standard_normal((2, 3, 32, 32)) \
        .astype(np.float32)
    want_heads = _ref_ssd(run, jnp.asarray(x))
    want = run("det", T(*want_heads))
    with torch.no_grad():
        heads = cs.ssd_forward(torch, port, torch.from_numpy(x))
        got = port["det"](list(heads))
    assert heads[2].shape[2] // 4 == 16 * 16 * 4 + 8 * 8 * 6
    for name, g, w in zip(("loc", "conf", "priors"), heads, want_heads):
        _close(g.numpy(), np.asarray(w), name)
    np.testing.assert_array_equal(got[..., 0].numpy(),
                                  np.asarray(want)[..., 0])
    _close(got[..., 1:].numpy(), np.asarray(want)[..., 1:], "rows")


def test_narrow_faster_rcnn_gives_the_references_detections():
    cfg = FRCNN_NARROW
    ref = cs.frcnn_build(jnn, cfg)
    port = cs.frcnn_build(tnn, cfg, device=CPU)
    run = _Ref(ref, port, 14)
    x = np.random.default_rng(14).standard_normal((1, 3) + cfg["image"]) \
        .astype(np.float32)
    im_info = np.array([[64.0, 96.0, 1.0, 1.0]], np.float32)
    f = run("conv5", run("trunk", jnp.asarray(x)))
    r = jnp.maximum(run("rpn_conv", f), 0.0)
    score = run("rpn_cls", r)
    n, c2, h, w = score.shape
    prob = jax.nn.softmax(score.reshape(n, 2, -1, w), axis=1) \
        .reshape(score.shape)
    props = run("proposal", T(prob, run("rpn_bbox", r), jnp.asarray(im_info)))
    pooled = run("roi", T(f, props[1]))
    hid = run("fc", pooled.reshape(pooled.shape[0], -1))
    want = run("det", T(jax.nn.softmax(run("cls", hid), axis=-1),
                        run("bbox", hid), props[1], jnp.asarray(im_info)))
    with torch.no_grad():
        rois, scores, got = cs.frcnn_forward(
            torch, port, torch.from_numpy(x), torch.from_numpy(im_info))
    _close(rois.numpy(), np.asarray(props[1]), "rois")
    _close(scores.numpy(), np.asarray(props[2]), "scores")
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want)[:, 0])
    _close(got[:, 1:].numpy(), np.asarray(want)[:, 1:], "rows")


def test_small_rpn_trains_as_the_reference():
    cfg = FRCNN_NARROW
    jm = cs.rpn_train_model(jnn, cs.frcnn_build(jnn, cfg))
    tm = cs.rpn_train_model(tnn, cs.frcnn_build(tnn, cfg, device=CPU))
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, 8, 8, 12)).astype(np.float32)
    a = len(cfg["ratios"]) * len(cfg["scales"])
    lab, box = cs.rpn_targets(np, rng, a, 4, 6, fg=12, bg=36)
    params, state = jm.setup(jax.random.PRNGKey(15),
                             jax.ShapeDtypeStruct(x.shape, jnp.float32))
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state)))
    method = jmethods.SGD(learningrate=0.01, momentum=0.9)
    step = jax_train_step(jm, cs.rpn_criterion(jnn), method)
    opt_state = method.init_state(params)
    y = T(jnp.asarray(lab), T(*[jnp.asarray(t) for t in box]))
    want = []
    for _ in range(3):
        params, state, opt_state, loss = step(
            params, state, opt_state, jax.random.PRNGKey(0), jnp.asarray(x),
            y)
        want.append(float(loss))
    topt = optim.SGD(learningrate=0.01, momentum=0.9)
    tstep = optim.make_train_step(tm, cs.rpn_criterion(tnn), topt)
    tstate = topt.init_state(dict(tm.named_parameters()))
    ty = [torch.from_numpy(lab), [torch.from_numpy(t) for t in box]]
    got = [float(tstep(tstate, torch.from_numpy(x), ty)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=REL)
    assert got[-1] < got[0]


# ------------------------------------------------------- across packages
def _detection_file(tmp_path):
    """A port ``Sequential`` of the narrow SSD's first stage, its norm,
    heads and PriorBox (flip off), and each detection head, written by
    the port."""
    parts = cs.ssd_build(tnn, SSD_NARROW, device=CPU)
    seq = tnn.Sequential()
    for m in (parts["stages"][0], parts["norm"],
              tnn.SpatialConvolution(8, 3 * 4, 3, 3, 1, 1, 1, 1, device=CPU),
              tnn.SpatialConvolution(8, 3 * 4, 3, 3, 1, 1, 1, 1, device=CPU),
              tnn.PriorBox([4.0], [8.0], [2.0], flip=False, img_size=32,
                           step=2.0, variances=[0.1, 0.1, 0.2, 0.2]),
              tnn.DetectionOutputSSD(4, nms_topk=40, keep_top_k=30),
              tnn.Proposal(40, 12, [0.5, 1.0, 2.0], [2.0, 4.0],
                           min_size=4.0),
              tnn.RoiPooling(3, 3, 1.0 / 16),
              tnn.DetectionOutputFrcnn(4, keep_top_k=20)):
        seq.add(m)
    seq.reset(16)
    with torch.no_grad():
        seq[1].scale.copy_(torch.linspace(15.0, 25.0, 8).reshape(1, 8, 1, 1))
    path = str(tmp_path / "detect.bigdl")
    save_module(seq, path)
    return seq, path


def _port_rows(seq, x, rng):
    """The file's layers on seeded inputs: the SSD stage's rows and the
    Faster R-CNN layers' outputs."""
    with torch.no_grad():
        src = seq[1](seq[0](x))
        n = x.shape[0]
        loc = seq[2](src).permute(0, 2, 3, 1).reshape(n, -1)
        conf = seq[3](src).permute(0, 2, 3, 1).reshape(n, -1)
        prior = seq[4](src)
        ssd = seq[5]([loc, conf, prior])
        a = 6
        props = seq[6](_t(rng.random((1, 2 * a, 4, 6)).astype(np.float32),
                          (rng.standard_normal((1, 4 * a, 4, 6)) * 0.3)
                          .astype(np.float32),
                          np.array([[64.0, 96.0, 1.0, 1.0]], np.float32)))
        pooled = seq[7]([torch.from_numpy(rng.standard_normal(
            (1, 8, 4, 6)).astype(np.float32)), props[0]])
        e = torch.softmax(pooled.reshape(12, -1)[:, :4], -1)
        frcnn = seq[8]([e, pooled.reshape(12, -1)[:, 4:20], props[0]])
    return [loc, conf, prior, ssd, props[0], props[1], pooled, frcnn]


def test_detection_file_loads_in_the_reference_and_back(tmp_path):
    seq, path = _detection_file(tmp_path)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    want = _port_rows(seq.eval(), x, np.random.default_rng(18))
    ref = jser.load_module(path)
    assert ref[4].aspect_ratios == [1.0, 2.0] and ref[4].num_priors == 3
    p, st = ref.params, ref.state
    src = ref[1].apply(p[1], st[1], ref[0].apply(p[0], st[0], jnp.asarray(
        x.numpy()), training=False)[0], training=False)[0]
    loc = jnp.transpose(ref[2].apply(p[2], st[2], src)[0], (0, 2, 3, 1)) \
        .reshape(2, -1)
    conf = jnp.transpose(ref[3].apply(p[3], st[3], src)[0], (0, 2, 3, 1)) \
        .reshape(2, -1)
    prior = ref[4].forward(src)
    for name, g, w in (("loc", want[0], loc), ("conf", want[1], conf),
                       ("prior", want[2], prior)):
        _close(g.numpy(), np.asarray(w), name)
    _rows_equal(want[3].numpy(), ref[5].forward(T(jnp.asarray(
        want[0].numpy()), jnp.asarray(want[1].numpy()),
        jnp.asarray(want[2].numpy()))), "ssd rows")
    jser.save_module(ref, str(tmp_path / "back.bigdl"))
    back = load_module(str(tmp_path / "back.bigdl"), device=CPU).eval()
    assert [type(m) for m in back] == [type(m) for m in seq]
    assert back[4].aspect_ratios == [1.0, 2.0]
    assert isinstance(back[6].anchor, tnn.Anchor)
    got = _port_rows(back, x, np.random.default_rng(18))
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i


def _priors(rng, p):
    xy = rng.random((p, 2))
    b = np.concatenate([xy, xy + rng.random((p, 2)) * 0.4 + 0.01], 1)
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), p)
    return np.stack([b.astype(np.float32).reshape(-1), var])[None]


def _j(*arrays):
    return T(*[jnp.asarray(a) for a in arrays])


def test_detection_output_ssd_ties_and_padding():
    """Equal confidences fed straight in (no softmax): the many rows of
    one score, those NMS zeroed and the padding keep the reference's
    order exactly."""
    rng = np.random.default_rng(9)
    p, c, n = 30, 3, 2
    prior = _priors(rng, p)
    loc = np.zeros((n, p * 4), np.float32)
    conf = np.full((n, p, c), 0.5, np.float32)
    conf[:, ::3, 2] = 0.25
    conf[:, 1::4, 1] = 0.2                        # below conf_thresh
    conf[1, :5] = 0.0
    conf = conf.reshape(n, -1)
    for topk in (400, 12):
        kw = dict(n_classes=c, nms_topk=topk, keep_top_k=100,
                  conf_thresh=0.3, conf_post_process=False)
        got = tnn.DetectionOutputSSD(**kw)(_t(loc, conf, prior)).numpy()
        want = np.asarray(jnn.DetectionOutputSSD(**kw).forward(
            _j(loc, conf, prior)))
        assert (got[..., 0] == -1).any()
        _rows_equal(got, want, f"ssd ties nms_topk {topk}")


# ------------------------------------------------ the detect phase's checks
def _row(label, score, box):
    return [float(label), float(score)] + [float(v) for v in box]


_A, _B, _C = [0, 0, 9, 9], [5, 0, 14, 9], [50, 50, 60, 60]   # IoU(A, B) 1/3
_PAD = _row(-1, 0, [0, 0, 0, 0])
_S = float(np.nextafter(np.float32(0.4), np.float32(1)))    # 0.4 + 1 ulp


def _tie_case(case):
    """(want, got, rule, passes) of one near-tie rule case: rows by hand,
    the rule of a real head or layer."""
    frcnn = cs._frcnn_rule(tnn.DetectionOutputFrcnn(
        3, nms_thresh=50 / 150, conf_thresh=0.05, keep_top_k=4))
    want = [_row(1, 0.5, _A), _row(2, _S, _C), _row(1, 0.4, _B), _PAD]
    if case == "identical":
        return want, want, frcnn, True
    if case == "nms_iou_tie":          # the card suppressed B: IoU at 1/3
        return want, want[:2] + [_PAD, _PAD], frcnn, True
    if case == "order_tie":            # C and B swapped: scores 1 ulp apart
        return want, [want[0], want[2], want[1], _PAD], frcnn, True
    if case == "box_fault":            # A's box moved by 2 pixels
        return want, [_row(1, 0.5, [2, 0, 11, 9])] + want[1:], frcnn, False
    if case == "tie_elsewhere":        # B sits at a tie; A's score is off
        return want, [_row(1, 0.501, _A)] + want[1:], frcnn, False
    if case == "top_k_cut":            # A at its class's top-k cut
        rule = {"conf_thresh": 0.01, "nms_thresh": 0.45, "normalized": True,
                "cut": torch.tensor([[[0.0, 0.0], [0.5, 0.3]]])}
        return [_row(1, 0.5, [0.1] * 4), _PAD], [_PAD, _PAD], rule, True
    assert case == "min_size"          # A's width exactly min_size * scale
    rule = {"nms_thresh": 0.7, "normalized": False, "cut": None,
            "min_size": (16.0, 8.0)}
    return ([_row(0, 0.9, [0, 0, 15, 30]), _row(-1, 0, _C)],
            [_row(-1, 0, _C), _row(-1, 0, _A)], rule, True)


@pytest.mark.parametrize("case", ["identical", "nms_iou_tie", "order_tie",
                                  "box_fault", "tie_elsewhere", "top_k_cut",
                                  "min_size"])
def test_near_tie_rule_excuses_only_a_tie_at_the_differing_row(case):
    """``detect``'s near-tie rule: the card's rows may part from the CPU's
    only at a first differing row whose own decision (its overlap with an
    earlier row, its order against the other row, its top-k cut, its
    size) the CPU took by a margin under DETECT_TIE_EPS (DETECT_TIE_PX);
    a near tie elsewhere in the image excuses nothing."""
    want, got, rule, passes = _tie_case(case)
    args = (torch, case, torch.tensor([got]), torch.tensor([want]), 1e-3,
            rule)
    if not passes:
        with pytest.raises(cs.SmokeFailure, match="no near tie"):
            cs._rows_near_tie(*args)
        return
    rec = cs._rows_near_tie(*args)
    assert rec["identical_images"] + rec["near_tie_images"] == 1
    assert rec["identical_images"] == (case == "identical")


def test_tie_rules_of_the_narrow_heads():
    """``_ssd_rule`` and ``_proposal_rule`` on real inputs: the scores
    either side of each class's top-k cut, the pre-NMS cut and the least
    box size; the CPU's rows against themselves are identical."""
    rng = np.random.default_rng(21)
    p, c, n = 60, 3, 2
    prior = _priors(rng, p)
    loc = (rng.standard_normal((n, p * 4)) * 0.5).astype(np.float32)
    conf = (rng.standard_normal((n, p * c)) * 2).astype(np.float32)
    head = tnn.DetectionOutputSSD(n_classes=c, nms_topk=25, keep_top_k=30)
    inputs = _t(loc, conf, prior)
    rule = cs._ssd_rule(torch, head, inputs)
    assert tuple(rule["cut"].shape) == (n, c, 2)
    assert (rule["cut"][..., 0] >= rule["cut"][..., 1]).all()
    rows = head(inputs)
    assert cs._rows_near_tie(torch, "ssd", rows, rows, 1e-5, rule)[
        "identical_images"] == n
    a, h, w = 6, 4, 6
    layer = tnn.Proposal(40, 12, [0.5, 1.0, 2.0], [2.0, 4.0], min_size=4.0)
    inputs = _t(rng.random((1, 2 * a, h, w)).astype(np.float32),
                (rng.standard_normal((1, 4 * a, h, w)) * 0.3)
                .astype(np.float32),
                np.array([[64.0, 96.0, 1.5, 1.25]], np.float32))
    rule = cs._proposal_rule(torch, layer, inputs)
    assert tuple(rule["cut"].shape) == (1, 1, 2)
    assert rule["min_size"] == (5.0, 6.0)
    rows = cs._proposal_rows(torch, *layer(inputs))
    assert tuple(rows.shape) == (12, 6)
    assert set(rows[:, 0].tolist()) <= {0.0, -1.0}
    assert cs._rows_near_tie(torch, "proposal", rows, rows, 1e-3, rule)[
        "identical_images"] == 1


def test_rpn_step_checks_on_the_cpu():
    """``detect``'s RPN checks run here on the plain versions: the hooks
    tap the flips the step runs (rpn_conv's; conv5's input carries no
    gradient) and every ReLU; each flip on the tapped gradient matches
    ``conv2d_input``; a run given its own ReLU decisions has its own
    gradients bit for bit, and one decision turned changes them."""
    cfg = FRCNN_NARROW
    model = cs.rpn_train_model(tnn, cs.frcnn_build(tnn, cfg, device=CPU))
    model.load_state_dict(init_state_dict(model, 3), strict=False)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 12))
                         .astype(np.float32))
    a = len(cfg["ratios"]) * len(cfg["scales"])
    lab, box = cs.rpn_targets(np, rng, a, 4, 6, fg=12, bg=36)
    y = [torch.from_numpy(lab), [torch.from_numpy(t) for t in box]]
    run = optim.make_loss_and_grads(model, cs.rpn_criterion(tnn))
    with cs._rpn_hooks(torch, model) as taps:
        _, grads = run(x, y)
    assert sorted(taps["dy"]) == ["1"] and len(taps["relu"]) == 2
    flips = cs._rpn_flips_vs_cpu(torch, model, taps["dy"], device=CPU)
    assert max(flips.values()) <= 1e-5
    with cs._rpn_hooks(torch, model, taps["relu"]):
        _, same = run(x, y)
    assert all(torch.equal(same[k], g) for k, g in grads.items())
    turned = {k: m.contiguous().clone() for k, m in taps["relu"].items()}
    turned["2"].view(-1)[int(turned["2"].view(-1).float().argmax())] = False
    with cs._rpn_hooks(torch, model, turned):
        _, moved = run(x, y)
    assert not all(torch.equal(moved[k], g) for k, g in grads.items())
