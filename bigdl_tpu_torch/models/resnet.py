"""ResNet (the port of ``bigdl_tpu/models/resnet.py``, reference
``models/resnet/ResNet.scala:58``).

Both variants: ImageNet ResNet-18/34 (basic blocks) and 50/101/152
(bottlenecks, v1.5: the stride on the 3x3), and CIFAR ResNet-(6n+2).
Shortcut "A" is treated as "B" (a 1x1 projection), as the reference does.

Every layer is registered on the model under the name the reference's
``set_name`` gives it, and carries it (``get_name()``): ("conv1",
"conv1_bn", "res2_0_conv2", "fc", ...;
the CIFAR variant's unnamed head keeps the reference's default names
"SpatialAveragePooling", "Reshape", "Linear", "LogSoftMax"), so each
state_dict key is ``<reference name>.<leaf>`` and weights carry across by
name (``convert.resnet_params_from_jax``). The forward walks the same
graph as the reference's ``Graph``: stem, then each block's shortcut and
main path joined by ``CAddTable`` and a ReLU, then the head.

``format`` ("NCHW" or "NHWC") defaults to ``BIGDL_TPU_ENABLE_NHWC``, as in
the reference. Every 3x3 stride-1 convolution runs on the hand-written
kernels of ``ops/conv3x3.py`` on the card (see ``nn/conv.py``).
"""

from __future__ import annotations

from torch import nn

from bigdl_tpu_torch.nn import (CAddTable, Linear, LogSoftMax, ReLU, Reshape,
                                SpatialAveragePooling,
                                SpatialBatchNormalization, SpatialConvolution,
                                SpatialMaxPooling)
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.flags import get_flag

_IMAGENET_CFGS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def default_data_format():
    """"NHWC" when ``BIGDL_TPU_ENABLE_NHWC`` is set, else "NCHW" (the
    reference's ``Engine.default_data_format``)."""
    return "NHWC" if get_flag("BIGDL_TPU_ENABLE_NHWC", False, bool) else "NCHW"


class ResNet(nn.Module):
    """``ResNet(class_num, depth, shortcut_type, data_set, format)`` (see
    module docstring); ``forward(x, generator=None)`` returns
    log-probabilities (B, class_num)."""

    quantizer_walks = True    # nn.quantized.Quantizer swaps in layers

    @classmethod
    def native_spec(cls):
        """The native format's entry (``utils/serializer.py``): the
        reference builds its ResNet as a ``Graph`` of the named layers, so
        the file holds :meth:`native_form` and loads back through
        :meth:`from_native_form`."""
        from bigdl_tpu_torch.utils.serializer import NativeSpec, built_inside
        return NativeSpec("bigdl_tpu.models.resnet:ResNet", cls,
                          build=built_inside("Graph"),
                          form=lambda m, sd: m.native_form(sd),
                          from_form=cls.from_native_form)

    def __init__(self, class_num=1000, depth=50, shortcut_type="B",
                 data_set="ImageNet", format=None, device=None):
        super().__init__()
        self.class_num, self.depth = class_num, depth
        self.shortcut_type, self.data_set = shortcut_type, data_set
        self.format = format or default_data_format()
        self._stem, self._blocks, self._head = [], [], []
        # every layer is built on the resolved device
        self._dev = resolve_device(device)
        if data_set.lower().startswith("cifar"):
            self._build_cifar(class_num, depth, shortcut_type)
        else:
            self._build_imagenet(class_num, depth, shortcut_type)

    # ------------------------------------------------------------ building
    def _add(self, name, module):
        self.add_module(name, module.set_name(name))
        return name

    def _conv_bn(self, n_in, n_out, k, stride, pad, name, with_relu=True):
        fmt = self.format
        names = [
            self._add(name, SpatialConvolution(
                n_in, n_out, k, k, stride, stride, pad, pad, with_bias=False,
                format=fmt, device=self._dev)),
            self._add(name + "_bn", SpatialBatchNormalization(
                n_out, format=fmt, device=self._dev))]
        if with_relu:
            names.append(self._add(name + "_relu", ReLU()))
        return names

    def _shortcut(self, n_in, n_out, stride, shortcut_type, name):
        # a change of shape takes a projection whatever the type (type A's
        # zero-padded identity is a projection here, as in the reference);
        # type C projects every shortcut
        if n_in == n_out and stride == 1 and shortcut_type != "C":
            return []
        fmt = self.format
        return [self._add(name + "_proj", SpatialConvolution(
                    n_in, n_out, 1, 1, stride, stride, with_bias=False,
                    format=fmt, device=self._dev)),
                self._add(name + "_proj_bn", SpatialBatchNormalization(
                    n_out, format=fmt, device=self._dev))]

    def _block(self, kind, n_in, planes, stride, shortcut_type, name):
        """Register one block; returns its output channels."""
        n_out = planes * 4 if kind == "bottleneck" else planes
        short = self._shortcut(n_in, n_out, stride, shortcut_type, name)
        if kind == "bottleneck":
            main = (self._conv_bn(n_in, planes, 1, 1, 0, name + "_conv1")
                    + self._conv_bn(planes, planes, 3, stride, 1,
                                    name + "_conv2")
                    + self._conv_bn(planes, n_out, 1, 1, 0, name + "_conv3",
                                    with_relu=False))
        else:
            main = (self._conv_bn(n_in, n_out, 3, stride, 1, name + "_conv1")
                    + self._conv_bn(n_out, n_out, 3, 1, 1, name + "_conv2",
                                    with_relu=False))
        self._blocks.append((main, short, self._add(name + "_add",
                                                    CAddTable()),
                             self._add(name + "_out", ReLU())))
        return n_out

    def _build_imagenet(self, class_num, depth, shortcut_type):
        kind, stages = _IMAGENET_CFGS[depth]
        self._stem = self._conv_bn(3, 64, 7, 2, 3, "conv1") + [
            self._add("pool1", SpatialMaxPooling(3, 3, 2, 2, 1, 1,
                                                 format=self.format))]
        n_in = 64
        for si, (n_blocks, planes) in enumerate(zip(stages,
                                                    [64, 128, 256, 512])):
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                n_in = self._block(kind, n_in, planes, stride, shortcut_type,
                                   f"res{si + 2}_{bi}")
        self._head = [
            self._add("pool5", SpatialAveragePooling(
                7, 7, global_pooling=True, format=self.format)),
            self._add("flatten", Reshape((n_in,))),
            self._add("fc", Linear(n_in, class_num, device=self._dev)),
            self._add("prob", LogSoftMax())]

    def _build_cifar(self, class_num, depth, shortcut_type):
        if (depth - 2) % 6:
            raise ValueError(f"CIFAR depth must be 6n+2, got {depth}")
        n = (depth - 2) // 6
        self._stem = self._conv_bn(3, 16, 3, 1, 1, "conv1")
        n_in = 16
        for si, planes in enumerate([16, 32, 64]):
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                n_in = self._block("basic", n_in, planes, stride,
                                   shortcut_type, f"res{si + 2}_{bi}")
        # the reference leaves these unnamed: their names are the defaults
        self._head = [
            self._add("SpatialAveragePooling", SpatialAveragePooling(
                8, 8, global_pooling=True, format=self.format)),
            self._add("Reshape", Reshape((64,))),
            self._add("Linear", Linear(64, class_num, device=self._dev)),
            self._add("LogSoftMax", LogSoftMax())]

    # ------------------------------------------------------------- running
    def _seq(self, names, x):
        for name in names:
            x = self._modules[name](x)
        return x

    def forward(self, x, generator=None):
        """Log-probabilities of images ``x`` in the model's ``format``;
        ``generator`` is unused (no layer draws), taken so
        ``optim.make_train_step`` drives this model as any other."""
        x = self._seq(self._stem, x)
        for main, short, add, out in self._blocks:
            x = self._modules[out](self._modules[add](
                self._seq(main, x), self._seq(short, x)))
        return self._seq(self._head, x)

    def as_graph(self):
        """The model as the reference builds it: a ``Graph`` over this
        model's own layers (shared, not copied), wired as :meth:`forward`
        runs them, each block's shortcut and main path from the block's
        input into its ``CAddTable`` (main path first). The native format
        writes a ``ResNet`` as this graph (``utils/serializer.py``)."""
        from bigdl_tpu_torch.nn import Graph, Input

        def seq(names, node):
            for name in names:
                node = self._modules[name](node)
            return node

        inp = Input()
        x = seq(self._stem, inp)
        for main, short, add, out in self._blocks:
            x = self._modules[out](self._modules[add](seq(main, x),
                                                      seq(short, x)))
        return Graph(inp, seq(self._head, x), device=self._dev)

    def native_form(self, state_dict=None):
        """``(graph, state_dict)`` as the native format writes the model:
        :meth:`as_graph`, carrying as ``_native_form`` the constructor
        values that build the model back, and ``state_dict`` (default the
        model's) keyed as the graph's."""
        graph = self.as_graph()
        graph.training = self.training       # its layers keep their own
        graph._native_form = {
            "class": "bigdl_tpu.models.resnet:ResNet",
            "class_num": self.class_num, "depth": self.depth,
            "shortcut_type": self.shortcut_type, "data_set": self.data_set,
            "format": self.format}
        sd = self.state_dict() if state_dict is None else state_dict
        return graph, {f"{i}.{leaf}": sd[f"{n.module.get_name()}.{leaf}"]
                       for i, n in enumerate(graph.exec_order)
                       for leaf in n.module.state_dict()}

    @classmethod
    def from_native_form(cls, graph, form, at):
        """The model of a graph that :meth:`native_form` wrote (``form``
        its ``_native_form``), with the graph's weights and modes, on
        ``at.device``."""
        from bigdl_tpu_torch.utils.serializer import assign
        model = cls(form["class_num"], form["depth"], form["shortcut_type"],
                    form["data_set"], form["format"], device=at.device)
        layers = {n.module.get_name(): n.module for n in graph.exec_order}
        assign(model, {f"{name}.{leaf}": t for name, m in layers.items()
                       for leaf, t in m.state_dict().items()})
        for name, layer in model.named_children():
            layer.training = layers[name].training
        model.training = graph.training
        return model

    def layer_walk(self, image_hw):
        """``(name, module, (h, w) of its input)`` for every layer in
        forward order on ``image_hw`` images (shortcut before main path, as
        the reference's graph orders them)."""
        hw = tuple(image_hw)
        walk = []

        def seq(names, hw):
            for name in names:
                module = self._modules[name]
                walk.append((name, module, hw))
                if hasattr(module, "output_hw"):
                    hw = module.output_hw(*hw)
            return hw

        hw = seq(self._stem, hw)
        for main, short, add, out in self._blocks:
            seq(short, hw)
            hw = seq(main, hw)
            seq([add, out], hw)
        seq(self._head, hw)
        return walk

