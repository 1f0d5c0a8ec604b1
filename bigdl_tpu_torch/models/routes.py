"""What one training step of an image model asks of the card, counted from
its layers: the layer walk, the 3x3 convolutions' kernel launches by path
(the yardstick ``chip_smoke.py`` holds the launch counters to) and the
operations of a forward pass.

:func:`layer_walk` walks a tree of ``Sequential``, ``Concat`` and
``ConcatTable`` containers (VGG, Inception, AlexNet, LeNet's
``Sequential``, a detector's RPN), a ``Graph``
(a Caffe-loaded model: its nodes in ``exec_order``, each fed the ``(h,
w)`` of its first input, its input depending on a parameter where any of
its inputs' does), or a model with a ``layer_walk`` method of its own
(``ResNet``).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import (Concat, ConcatTable, Graph, Linear,
                                Sequential, SpatialConvolution)
from bigdl_tpu_torch.ops.conv3x3 import kernel_for, tc_path


def _has_params(module):
    return any(True for _ in module.parameters(recurse=False))


def _walk(module, hw, grad, out):
    """Append ``module``'s leaves to ``out``; returns the output's (h, w)
    and whether it depends on a parameter."""
    if isinstance(module, Sequential):
        for child in module:
            hw, grad = _walk(child, hw, grad, out)
        return hw, grad
    if isinstance(module, (Concat, ConcatTable)):
        ends = [_walk(child, hw, grad, out) for child in module]
        return ends[0][0], any(g for _, g in ends)
    if isinstance(module, Graph):
        ends = {}
        for node in module.exec_order:
            ins = [ends[p.id] for p in node.prev_nodes] or [(hw, grad)]
            ends[node.id] = _walk(node.module, ins[0][0],
                                  any(g for _, g in ins), out)
        return ends[module.output_nodes[0].id]
    if any(True for _ in module.children()):
        raise TypeError(f"layer_walk does not walk a "
                        f"{type(module).__name__}")
    out.append((module, hw, grad))
    if hasattr(module, "output_hw"):
        hw = module.output_hw(*hw)
    return hw, grad or _has_params(module)


def layer_walk(model, image_hw):
    """``(module, (h, w) of its input, whether its input depends on a
    parameter)`` for every layer of ``model`` in forward order on
    ``image_hw`` images. A layer whose input depends on no parameter (the
    first convolution, reading the images) needs no input gradient."""
    out = []
    if hasattr(model, "layer_walk"):
        # ResNet: a chain through its stem, so every layer after the first
        # one with parameters reads a value that depends on one
        grad = False
        for _, m, hw in model.layer_walk(image_hw):
            out.append((m, hw, grad))
            grad = grad or _has_params(m)
        return out
    _walk(model, tuple(image_hw), False, out)
    return out


def conv_routes(model, image_hw=(224, 224), dtype=None, training=True):
    """How one training step of ``model`` on ``image_hw`` images runs its
    convolutions (with ``training=False``, one forward pass: no input
    gradient). Every 3x3 stride-1 pad-1 convolution launches its
    kernel once a group forward (by the group's input channels,
    ``ops.conv3x3.kernel_for``) and once a group for the input gradient
    (by its output channels; none where the input depends on no
    parameter); every other convolution is one ``F.conv2d`` forward.
    Each layer reports its own launches (its ``conv_launches(h, w,
    grad)``: ``[(cin, cout, width, n)]``, or None for one library call).

    A graph that writes its own input gradients (a layer sets
    ``writes_input_grads``: an imported TF training graph's
    ``ops.tf_ops.ConvBackpropInput``) takes its step by evaluation: its
    convolutions count their forward only, and the gradient layers their
    own launches.

    Without ``dtype``: ``{"i2c": n, "k9": n, "library": n}``. With a
    compute ``dtype``: each kernel's launches split by path, ``{"i2c":
    {"tc": n, "simt": n}, "k9": {...}, "library": n}``, by the rule of
    ``ops.conv3x3.tc_path`` (float32 runs on the CUDA cores, ``simt``)."""
    split = {"i2c": {"tc": 0, "simt": 0}, "k9": {"tc": 0, "simt": 0},
             "library": 0}
    cast = dtype if dtype is not None else torch.float32
    walk = layer_walk(model, image_hw)
    by_evaluation = any(getattr(m, "writes_input_grads", False)
                        for m, _, _ in walk)
    for m, (h, w), grad in walk:
        if not hasattr(m, "conv_launches"):
            continue
        launches = m.conv_launches(h, w, grad and training
                                   and not by_evaluation)
        if launches is None:
            split["library"] += 1
        for cin, cout, width, n in launches or ():
            kind = kernel_for(cin)
            path = "tc" if tc_path(kind, cast, width, cin, cout) else "simt"
            split[kind][path] += n
    if dtype is not None:
        return split
    return {"i2c": sum(split["i2c"].values()),
            "k9": sum(split["k9"].values()), "library": split["library"]}


def model_flops(model, image_hw=(224, 224)):
    """Operations of one image's forward pass, counted from the layers: 2
    per multiply-add of every convolution (a grouped one's groups each
    over its own channels) and every ``Linear`` (BN, LRN, ReLU, pooling,
    dropout and additions are not counted). ResNet-50 at 224 x 224: about
    8.2e9. A training step is about 3x this per image."""
    total = 0
    for m, (h, w), _ in layer_walk(model, image_hw):
        if isinstance(m, SpatialConvolution):
            oh, ow = m.output_hw(h, w)
            total += (2 * oh * ow * m.kernel_h * m.kernel_w
                      * m.n_input_plane // m.n_group * m.n_output_plane)
        elif isinstance(m, Linear):
            total += 2 * m.input_size * m.output_size
    return total


# the name ResNet's callers know it by
resnet_flops = model_flops
