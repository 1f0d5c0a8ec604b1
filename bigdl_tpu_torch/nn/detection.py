"""Object-detection layers (the port of ``bigdl_tpu/nn/detection.py``): the
box math, greedy NMS, ``Anchor``, ``PriorBox``, ``Proposal``,
``RoiPooling``, ``DetectionOutputSSD`` and ``DetectionOutputFrcnn``.

Every output keeps the reference's fixed size: ``Proposal`` gives
``post_nms_topn`` rows, suppressed ones carrying score -inf;
``DetectionOutputSSD`` and ``DetectionOutputFrcnn`` give ``keep_top_k``
rows ``[label, score, x1, y1, x2, y2]``, padded with label -1. Tables in
and out are lists (a ``utils.table.Table`` or dict is read in key order).

Order among equal scores decides real output (the padded rows, the -inf
proposals, the scores NMS zeroed): the reference sorts with a stable
``argsort`` and selects with ``lax.top_k``, which puts the lower index
first. Here every selection is a stable descending ``torch.sort``
(:func:`top_k`), which keeps that order on the CPU and the card alike
(``torch.topk`` promises none among ties on the card).

Greedy NMS (:func:`nms_keep`) sweeps every (image, class) row of a batch
at once: one loop over the candidate index, two tensor operations a step
on the whole batch of rows, and no value read back to the host inside it
(``SWEEP`` counts its calls, steps and launches). ``RoiPooling`` reduces
the reference's masked max over (R, C, pooled_h, pooled_w, H, W) one
pooled column at a time, first over the width and then over the height,
so no tensor it makes is larger than the (R, C, H, W) map of its RoIs
(the rectangle's max is the max of its columns' maxima, exactly).

Quotients that decide a box or a bin (``PriorBox``'s normalisation,
``RoiPooling``'s bin sizes) divide by a tensor (:func:`_div`): on CUDA,
PyTorch turns a division by a Python number into a multiply by its
reciprocal, which can differ in the last bit and move a bin's edge.

The host-facing helpers (``Nms.nms`` on arrays, ``Anchor.generate_anchors``)
place their tensors as every entry point does: on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.table_ops import _elems
from bigdl_tpu_torch.utils.device import resolve_device

# the NMS sweep's work, counted on the host: calls of nms_keep, steps of
# its loop (one a candidate), and the tensor operations those steps launch
SWEEP = {"calls": 0, "steps": 0, "launches": 0}


def reset_sweep_counts():
    for k in SWEEP:
        SWEEP[k] = 0


# --------------------------------------------------------------------- boxes

def areas(boxes, normalized=False):
    """Box areas; Pascal (+1) convention unless ``normalized`` ([0, 1]
    coordinates)."""
    off = 0.0 if normalized else 1.0
    return ((boxes[..., 2] - boxes[..., 0] + off)
            * (boxes[..., 3] - boxes[..., 1] + off))


def iou_matrix(boxes_a, boxes_b, normalized=False):
    """Pairwise IoU (..., A, B) of boxes (..., A, 4) and (..., B, 4)."""
    off = 0.0 if normalized else 1.0
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (torch.clamp_min(x2 - x1 + off, 0.0)
             * torch.clamp_min(y2 - y1 + off, 0.0))
    union = (areas(boxes_a, normalized)[..., :, None]
             + areas(boxes_b, normalized)[..., None, :] - inter)
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def bbox_transform_inv(boxes, deltas):
    """(dx, dy, dw, dh) regression deltas applied to boxes, Faster R-CNN's
    convention; both (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = (deltas[..., 0], deltas[..., 1], deltas[..., 2],
                      deltas[..., 3])
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], -1)


def _bound(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def clip_boxes(boxes, height, width):
    """Boxes (..., 4) clamped into a ``height`` x ``width`` image (numbers
    or 0-d tensors)."""
    hi = (_bound(width, boxes) - 1.0, _bound(height, boxes) - 1.0)
    return torch.stack([torch.minimum(torch.clamp_min(boxes[..., i], 0.0),
                                      hi[i % 2]) for i in range(4)], -1)


def decode_boxes(priors, variances, deltas, variance_encoded=False):
    """SSD's centre-size decoding of ``deltas`` (..., 4) against
    ``priors`` and their ``variances`` (..., 4), corner boxes in [0, 1];
    with ``variance_encoded`` the variances are 1."""
    pw = priors[..., 2] - priors[..., 0]
    ph = priors[..., 3] - priors[..., 1]
    pcx = (priors[..., 0] + priors[..., 2]) * 0.5
    pcy = (priors[..., 1] + priors[..., 3]) * 0.5
    v = torch.ones_like(variances) if variance_encoded else variances
    cx = v[..., 0] * deltas[..., 0] * pw + pcx
    cy = v[..., 1] * deltas[..., 1] * ph + pcy
    w = torch.exp(v[..., 2] * deltas[..., 2]) * pw
    h = torch.exp(v[..., 3] * deltas[..., 3]) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], -1)


def _div(x, d):
    """``x / d`` correctly rounded on every device (module docstring)."""
    return x / torch.full_like(x, float(d))


def top_k(x, k):
    """The ``k`` largest of ``x`` along its last axis and their indices,
    descending, the lower index first among equal values (``lax.top_k``'s
    order) on every device."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ----------------------------------------------------------------------- NMS

def _sweep(over):
    """Greedy suppression of rows of candidates sorted best first:
    ``over`` (R, n, n) says which pairs overlap past the threshold; box
    ``i`` is kept when no kept box before it overlaps it. ``alive`` holds
    1 until a kept box removes a candidate; step ``i`` reads its own
    entry, final by then, on the card, and removes the later boxes that
    ``i`` overlaps if it is alive: two operations on all R rows, nothing
    read back."""
    r, n = over.shape[0], over.shape[-1]
    later = torch.ones(n, n, dtype=torch.bool, device=over.device).triu(1)
    over = (over & later).to(torch.float32)
    alive = torch.ones(r, n, dtype=torch.float32, device=over.device)
    one = torch.ones(1, 1, dtype=torch.float32, device=over.device)
    # the views a step reads, made once (``alive``'s columns see its
    # in-place updates), and one buffer for the step's factor
    rows, cols = over.unbind(1), alive.split(1, 1)
    factor = torch.empty_like(alive)
    for i in range(n):
        torch.addcmul(one, rows[i], cols[i], value=-1.0, out=factor)
        alive.mul_(factor)
    SWEEP["calls"] += 1
    SWEEP["steps"] += n
    SWEEP["launches"] += 2 * n
    return alive > 0.5


def nms_keep(boxes, scores, thresh, normalized=False):
    """Greedy NMS of boxes (..., n, 4) by scores (..., n), every leading
    index a row of its own. Returns ``(order, keep)``: ``order`` the
    indices by descending score (a stable sort: the lower index first
    among equal scores) and ``keep[..., i]`` whether ``order[..., i]``
    survives, as the reference's ``nms_keep`` (``Nms.scala``'s walk over
    a mutable ``suppressed`` array)."""
    lead, n = tuple(scores.shape[:-1]), scores.shape[-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, -2,
                          order[..., None].expand(*order.shape, 4))
    over = iou_matrix(sboxes, sboxes, normalized) > thresh
    keep = _sweep(over.reshape(-1, n, n)).reshape(*lead, n)
    return order, keep


class Nms:
    """The reference's host-facing NMS (``nn/Nms.scala``): ``nms(scores,
    boxes, thresh)`` returns the kept indices, highest score first, as a
    numpy int32 array. Tensors are swept where they lie; arrays on
    ``device`` (the card unless ``device="cpu"``)."""

    def nms(self, scores, boxes, thresh, normalized=False, device=None):
        if not isinstance(scores, torch.Tensor):
            scores = torch.as_tensor(scores, device=resolve_device(device))
        boxes = torch.as_tensor(boxes, device=scores.device)
        if scores.numel() == 0:
            return np.zeros((0,), np.int32)
        order, keep = nms_keep(boxes, scores, thresh, normalized=normalized)
        return order[keep].cpu().numpy().astype(np.int32)


def _nms_scores(boxes, scores, nms_thresh, normalized=True):
    """Scores (..., n) with the entries NMS suppressed set to 0."""
    order, keep = nms_keep(boxes, scores, nms_thresh, normalized=normalized)
    mask = torch.zeros_like(keep).scatter(-1, order, keep)
    return torch.where(mask, scores, torch.zeros_like(scores))


# -------------------------------------------------------------------- Anchor

class Anchor:
    """Faster R-CNN's anchors (reference ``nn/Anchor.scala``): the basic
    anchors of every (ratio, scale), computed once on the host with
    numpy, shifted over a feature map's grid."""

    def __init__(self, ratios, scales, base_size=16.0):
        self.ratios = np.asarray(ratios, np.float32)
        self.scales = np.asarray(scales, np.float32)
        self.anchor_num = len(self.ratios) * len(self.scales)
        self.basic_anchors = torch.from_numpy(
            self._generate_basic(self.ratios, self.scales, base_size))

    @staticmethod
    def _mk(ws, hs, xc, yc):
        w, h = ws / 2.0 - 0.5, hs / 2.0 - 0.5
        return np.stack([xc - w, yc - h, xc + w, yc + h], axis=1)

    @classmethod
    def _generate_basic(cls, ratios, scales, base_size):
        base = np.array([0.0, 0.0, base_size - 1, base_size - 1], np.float32)
        w = base[2] - base[0] + 1
        h = base[3] - base[1] + 1
        xc, yc = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
        # ratio enumeration: ws = round(sqrt(area/ratio)), hs = round(ws*ratio)
        ws = np.round(np.sqrt(w * h / ratios))
        hs = np.round(ws * ratios)
        ratio_anchors = cls._mk(ws, hs, xc, yc)
        out = []
        for ra in ratio_anchors:
            rw, rh = ra[2] - ra[0] + 1, ra[3] - ra[1] + 1
            rxc, ryc = ra[0] + 0.5 * (rw - 1), ra[1] + 0.5 * (rh - 1)
            out.append(cls._mk(scales * rw, scales * rh, rxc, ryc))
        return np.concatenate(out, axis=0).astype(np.float32)

    def generate_anchors(self, width, height, feat_stride=16.0, device=None):
        """Every anchor over a (height, width) feature map, (H*W*A, 4),
        enumerated (y, x, anchor) as the reference's grid, on ``device``
        (the card unless ``device="cpu"``)."""
        device = resolve_device(device)
        shift_x = torch.arange(width, dtype=torch.float32,
                               device=device) * feat_stride
        shift_y = torch.arange(height, dtype=torch.float32,
                               device=device) * feat_stride
        sx, sy = torch.meshgrid(shift_x, shift_y, indexing="xy")  # (H, W)
        shifts = torch.stack([sx, sy, sx, sy], -1)
        basic = torch.as_tensor(self.basic_anchors, device=shifts.device)
        return (shifts[:, :, None, :] + basic[None, None]).reshape(-1, 4)


# ------------------------------------------------------------------ PriorBox

class PriorBox(Module):
    """SSD's prior (default) boxes for one feature map (reference
    ``nn/PriorBox.scala``). Input: the feature map (N, C, H, W); output
    (1, 2, H*W*num_priors*4): row 0 the boxes (normalised corners), row 1
    their variances. ``aspect_ratios`` keeps the expanded list (1 first,
    then each new ratio and, with ``flip``, its inverse)."""

    def __init__(self, min_sizes, max_sizes=None, aspect_ratios=None,
                 flip=True, clip=False, variances=None, offset=0.5,
                 img_h=0, img_w=0, img_size=0, step_h=0.0, step_w=0.0,
                 step=0.0):
        super().__init__()
        self.min_sizes = list(min_sizes)
        self.max_sizes = list(max_sizes or [])
        ars = [1.0]
        for ar in (aspect_ratios or []):
            if any(abs(ar - a) < 1e-6 for a in ars):
                continue
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
        self.aspect_ratios = ars
        self.clip = clip
        if variances is None:
            variances = [0.1]
        if len(variances) not in (1, 4):
            raise ValueError("must provide 1 or 4 variances")
        self.variances = list(variances)
        self.offset = offset
        self.img_h = img_h or img_size
        self.img_w = img_w or img_size
        self.step_h = step_h or step
        self.step_w = step_w or step
        self.num_priors = (len(self.aspect_ratios) * len(self.min_sizes)
                           + len(self.max_sizes))

    def forward(self, x):
        layer_h, layer_w = x.shape[2], x.shape[3]
        img_h = self.img_h or layer_h
        img_w = self.img_w or layer_w
        step_h = self.step_h or img_h / layer_h
        step_w = self.step_w or img_w / layer_w
        pw, ph = [], []
        for i, mn in enumerate(self.min_sizes):
            pw.append(mn)
            ph.append(mn)
            if self.max_sizes:
                s = math.sqrt(mn * self.max_sizes[i])
                pw.append(s)
                ph.append(s)
            for ar in self.aspect_ratios:
                if abs(ar - 1.0) < 1e-6:
                    continue
                pw.append(mn * math.sqrt(ar))
                ph.append(mn / math.sqrt(ar))
        f32 = dict(dtype=torch.float32, device=x.device)
        pw = _div(torch.tensor(pw, **f32) * 0.5, img_w)  # half-width
        ph = _div(torch.tensor(ph, **f32) * 0.5, img_h)
        cx = _div((torch.arange(layer_w, **f32) + self.offset) * step_w,
                  img_w)
        cy = _div((torch.arange(layer_h, **f32) + self.offset) * step_h,
                  img_h)
        gx, gy = torch.meshgrid(cx, cy, indexing="xy")  # (H, W)
        gx, gy = gx[:, :, None], gy[:, :, None]
        boxes = torch.stack([gx - pw, gy - ph, gx + pw, gy + ph], -1)
        if self.clip:
            boxes = torch.clamp(boxes, 0.0, 1.0)
        flat = boxes.reshape(-1)
        if len(self.variances) == 1:
            var = torch.full_like(flat, self.variances[0])
        else:
            var = torch.tensor(self.variances, **f32).repeat(
                flat.shape[0] // 4)
        return torch.stack([flat, var])[None]


# ------------------------------------------------------------------ Proposal

class Proposal(Module):
    """The RPN's proposal layer (reference ``nn/Proposal.scala``). Input:
    a table (scores (1, 2A, H, W), deltas (1, 4A, H, W), im_info (1, 4) =
    (height, width, scale_h, scale_w)). Output: a list (rois
    (post_nms_topn, 5) [batch index, x1, y1, x2, y2], scores
    (post_nms_topn,)), suppressed rows padding it with score -inf. In
    training mode the ``*_train`` counts apply."""

    def __init__(self, pre_nms_topn, post_nms_topn, ratios, scales,
                 rpn_pre_nms_topn_train=None, rpn_post_nms_topn_train=None,
                 min_size=16.0, nms_thresh=0.7):
        super().__init__()
        self.pre_nms_topn = pre_nms_topn
        self.post_nms_topn = post_nms_topn
        self.pre_nms_topn_train = rpn_pre_nms_topn_train or pre_nms_topn
        self.post_nms_topn_train = rpn_post_nms_topn_train or post_nms_topn
        self.anchor = Anchor(ratios, scales)
        self.min_size = min_size
        self.nms_thresh = nms_thresh

    def _candidates(self, xs):
        """Every anchor's decoded, clipped box, its object score (-inf
        below ``min_size``) and the (pre, post) NMS counts."""
        score_map, delta_map, im_info = _elems(xs)[:3]
        a = self.anchor.anchor_num
        h, w = score_map.shape[2], score_map.shape[3]
        # object scores are the second A channels; (h, w, a) enumeration
        scores = score_map[0, a:].permute(1, 2, 0).reshape(-1)
        deltas = delta_map[0].reshape(a, 4, h, w).permute(2, 3, 0, 1) \
            .reshape(-1, 4)
        anchors = self.anchor.generate_anchors(w, h, device=scores.device)
        im_info = torch.as_tensor(im_info, dtype=scores.dtype,
                                  device=scores.device)
        proposals = clip_boxes(bbox_transform_inv(anchors, deltas),
                               im_info[0, 0], im_info[0, 1])
        # drop boxes below min size at the original image's scale
        ws = proposals[:, 2] - proposals[:, 0] + 1
        hs = proposals[:, 3] - proposals[:, 1] + 1
        big = ((ws >= self.min_size * im_info[0, 3])
               & (hs >= self.min_size * im_info[0, 2]))
        scores = torch.where(big, scores, torch.full_like(scores, -math.inf))
        pre_n = min(self.pre_nms_topn_train if self.training
                    else self.pre_nms_topn, scores.shape[0])
        post_n = (self.post_nms_topn_train if self.training
                  else self.post_nms_topn)
        return proposals, scores, pre_n, post_n

    def forward(self, *xs):
        proposals, scores, pre_n, post_n = self._candidates(xs)
        top_scores, top_idx = top_k(scores, pre_n)
        top_boxes = proposals[top_idx]
        order, keep = nms_keep(top_boxes, top_scores, self.nms_thresh)
        # the first post_n kept rows, then the suppressed ones, each in
        # order: rank kept rows by position, the others after them
        pos = torch.arange(pre_n, device=keep.device)
        rank = torch.where(keep, pos, pre_n + pos)
        sel = torch.argsort(rank)[:post_n]
        picked = order[sel]
        out_boxes = top_boxes[picked]
        out_scores = torch.where(keep[sel], top_scores[picked],
                                 torch.full_like(top_scores[picked],
                                                 -math.inf))
        rois = torch.cat([torch.zeros_like(out_boxes[:, :1]), out_boxes], 1)
        return [rois, out_scores]


# ---------------------------------------------------------------- RoiPooling

class RoiPooling(Module):
    """RoI max pooling (reference ``nn/RoiPooling.scala``). Input: a table
    (data (N, C, H, W), rois (R, 5) [batch index, x1, y1, x2, y2]);
    output (R, C, pooled_h, pooled_w). Caffe's bins: bin (i, j) covers
    rows [floor(i * bin_h), ceil((i + 1) * bin_h)) and the like for
    columns, offset by the RoI's rounded corner (half to even, as
    ``jnp.round``), clamped to the map; an empty bin gives 0. Reduced one
    pooled column at a time (module docstring)."""

    def __init__(self, pooled_w, pooled_h, spatial_scale=1.0):
        super().__init__()
        self.pooled_w, self.pooled_h = pooled_w, pooled_h
        self.spatial_scale = spatial_scale

    def forward(self, *xs):
        data, rois = _elems(xs)[:2]
        n, c, h, w = data.shape
        rois = torch.as_tensor(rois, dtype=data.dtype, device=data.device)
        r = rois.shape[0]
        corners = torch.round(rois[:, 1:5] * self.spatial_scale)
        x1, y1, x2, y2 = corners.unbind(1)
        bin_w = _div(torch.clamp_min(x2 - x1 + 1.0, 1.0), self.pooled_w)
        bin_h = _div(torch.clamp_min(y2 - y1 + 1.0, 1.0), self.pooled_h)

        def bounds(k, size, bin_, start):
            p = torch.arange(k, dtype=data.dtype, device=data.device)[None]
            lo = torch.floor(p * bin_[:, None]) + start[:, None]
            hi = torch.ceil((p + 1) * bin_[:, None]) + start[:, None]
            at = torch.arange(size, dtype=data.dtype, device=data.device)
            lo, hi = lo.clamp(0, size), hi.clamp(0, size)
            return (at >= lo[..., None]) & (at < hi[..., None])   # (R, k, L)

        mask_w = bounds(self.pooled_w, w, bin_w, x1)
        mask_h = bounds(self.pooled_h, h, bin_h, y1)
        maps = (data.expand(r, c, h, w) if n == 1
                else data.index_select(0, rois[:, 0].long()))
        neg = torch.tensor(-math.inf, dtype=data.dtype, device=data.device)
        cols = []
        for j in range(self.pooled_w):
            colmax = torch.where(mask_w[:, None, None, j], maps,
                                 neg).amax(-1)                      # (R, C, H)
            cols.append(torch.where(mask_h[:, None], colmax[:, :, None],
                                    neg).amax(-1))              # (R, C, ph)
        out = torch.stack(cols, -1)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


# ------------------------------------------------------- detection outputs

def _rows(top_s, top_i, labels, boxes, keep_top_k):
    """``[label, score, box]`` rows of the selected entries, labels -1
    where the score is 0, padded to ``keep_top_k`` rows of (-1, 0, ...)."""
    lab = torch.where(top_s > 0, labels[top_i], torch.full_like(top_s, -1.0))
    box = torch.gather(boxes, -2, top_i[..., None].expand(*top_i.shape, 4))
    rows = torch.cat([lab[..., None], top_s[..., None], box], -1)
    k = rows.shape[-2]
    if k < keep_top_k:
        pad = rows.new_zeros(*rows.shape[:-2], keep_top_k - k, 6)
        pad[..., 0] = -1.0
        rows = torch.cat([rows, pad], -2)
    return rows


class DetectionOutputSSD(Module):
    """SSD's post-processing head (reference ``nn/DetectionOutputSSD.scala``).
    Input: a table (loc (N, P*4), conf (N, P*n_classes), priors (1, 2,
    P*4)). Per image and foreground class: scores (softmax of ``conf``
    with ``conf_post_process``) below ``conf_thresh`` set to 0, the
    ``nms_topk`` best decoded boxes through NMS at ``nms_thresh`` (every
    image's classes in one sweep); then the ``keep_top_k`` best of all
    classes. Output (N, keep_top_k, 6)."""

    def __init__(self, n_classes=21, share_location=True, bg_label=0,
                 nms_thresh=0.45, nms_topk=400, keep_top_k=200,
                 conf_thresh=0.01, variance_encoded_in_target=False,
                 conf_post_process=True):
        super().__init__()
        if not share_location:
            raise NotImplementedError("share_location=False not supported")
        self.n_classes = n_classes
        self.bg_label = bg_label
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.keep_top_k = keep_top_k
        self.conf_thresh = conf_thresh
        self.variance_encoded = variance_encoded_in_target
        self.conf_post_process = conf_post_process

    def _scores(self, xs):
        """The decoded boxes (N, P, 4), the foreground classes, and their
        scores (N, K, P) after the threshold and NMS."""
        loc, conf, prior = _elems(xs)[:3]
        n, p = loc.shape[0], loc.shape[1] // 4
        priors = prior[0, 0].reshape(p, 4)
        variances = prior[0, 1].reshape(p, 4)
        conf = conf.reshape(n, p, self.n_classes)
        if self.conf_post_process:
            conf = torch.softmax(conf, -1)
        decoded = decode_boxes(priors, variances, loc.reshape(n, p, 4),
                               self.variance_encoded)          # (N, P, 4)
        classes = [c for c in range(self.n_classes) if c != self.bg_label]
        s = conf[:, :, classes].permute(0, 2, 1)                # (N, K, P)
        s = torch.where(s >= self.conf_thresh, s, torch.zeros_like(s))
        boxes = decoded[:, None].expand(n, len(classes), p, 4)
        if self.nms_topk and self.nms_topk < p:
            # the nms_topk candidates first, so the IoU matrix and the
            # sweep run on k boxes, not all P priors
            topv, topi = top_k(s, self.nms_topk)
            cand = torch.gather(boxes, 2,
                                topi[..., None].expand(*topi.shape, 4))
            kept = _nms_scores(cand, topv, self.nms_thresh)
            s = torch.zeros_like(s).scatter(-1, topi, kept)
        else:
            s = _nms_scores(boxes, s, self.nms_thresh)
        return decoded, classes, s

    def forward(self, *xs):
        decoded, classes, s = self._scores(xs)
        n, p = decoded.shape[:2]
        all_scores = s.reshape(n, -1)                           # class-major
        labels = torch.tensor(classes, dtype=s.dtype, device=s.device) \
            .repeat_interleave(p)
        top_s, top_i = top_k(all_scores, min(self.keep_top_k,
                                             all_scores.shape[1]))
        return _rows(top_s, top_i, labels,
                     decoded.repeat(1, len(classes), 1), self.keep_top_k)


class DetectionOutputFrcnn(Module):
    """Faster R-CNN's post-processing (reference
    ``nn/DetectionOutputFrcnn.scala``). Input: a table (class
    probabilities (R, n_classes), box deltas (R, n_classes*4), rois (R,
    5)[, im_info (1, 4)]). Per foreground class: the RoIs decoded by the
    class's deltas (clipped to the image with ``im_info``), scores below
    ``conf_thresh`` set to 0, NMS at ``nms_thresh`` (all classes in one
    sweep); then the ``keep_top_k`` best. Output (keep_top_k, 6)."""

    def __init__(self, n_classes=21, bg_label=0, nms_thresh=0.3,
                 conf_thresh=0.05, keep_top_k=100):
        super().__init__()
        self.n_classes = n_classes
        self.bg_label = bg_label
        self.nms_thresh = nms_thresh
        self.conf_thresh = conf_thresh
        self.keep_top_k = keep_top_k

    def _scores(self, xs):
        items = _elems(xs)
        cls_prob, bbox_pred, rois = items[:3]
        im_info = items[3] if len(items) > 3 else None
        r = cls_prob.shape[0]
        classes = [c for c in range(self.n_classes) if c != self.bg_label]
        deltas = bbox_pred.reshape(r, self.n_classes, 4)[:, classes] \
            .permute(1, 0, 2)                                   # (K, R, 4)
        decoded = bbox_transform_inv(rois[None, :, 1:5], deltas)
        if im_info is not None:
            im_info = torch.as_tensor(im_info, dtype=decoded.dtype,
                                      device=decoded.device)
            decoded = clip_boxes(decoded, im_info[0, 0], im_info[0, 1])
        s = cls_prob[:, classes].T                              # (K, R)
        s = torch.where(s >= self.conf_thresh, s, torch.zeros_like(s))
        s = _nms_scores(decoded, s, self.nms_thresh, normalized=False)
        return decoded, classes, s

    def forward(self, *xs):
        decoded, classes, s = self._scores(xs)
        r = decoded.shape[1]
        labels = torch.tensor(classes, dtype=s.dtype, device=s.device) \
            .repeat_interleave(r)
        all_scores = s.reshape(-1)
        top_s, top_i = top_k(all_scores, min(self.keep_top_k,
                                             all_scores.shape[0]))
        return _rows(top_s, top_i, labels, decoded.reshape(-1, 4),
                     self.keep_top_k)
