"""LeNet-5 (the port of ``bigdl_tpu/models/lenet.py``, reference
``models/lenet/LeNet5.scala``): input 1x28x28 NCHW, conv5x5x6 -> tanh ->
pool -> conv5x5x12 -> tanh -> pool -> fc100 -> tanh -> fc(class_num) ->
logsoftmax, as a ``Sequential`` or a ``Graph``.

The 5x5 convolutions go to ``F.conv2d``: no TPU kernel computes them (the
reference leaves them to XLA). Both builders return seeded weights
(``Module.reset(seed)``, the reference's initializers' distributions);
weights carried from the reference go through
``convert.module_params_from_jax``.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def LeNet5(class_num=10, device=None, seed=1):
    dev = resolve_device(device)
    return (nn.Sequential()
            .add(nn.Reshape((1, 28, 28)))
            .add(nn.SpatialConvolution(1, 6, 5, 5, device=dev)
                 .set_name("conv1_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.SpatialConvolution(6, 12, 5, 5, device=dev)
                 .set_name("conv2_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Reshape((12 * 4 * 4,)))
            .add(nn.Linear(12 * 4 * 4, 100, device=dev).set_name("fc_1"))
            .add(nn.Tanh())
            .add(nn.Linear(100, class_num, device=dev).set_name("fc_2"))
            .add(nn.LogSoftMax())).reset(seed)


def lenet_graph(class_num=10, device=None, seed=1):
    """Graph builder variant (reference ``LeNet5.graph``)."""
    dev = resolve_device(device)
    inp = nn.Input()
    x = nn.Reshape((1, 28, 28))(inp)
    x = nn.SpatialConvolution(1, 6, 5, 5, device=dev)(x)
    x = nn.Tanh()(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2)(x)
    x = nn.SpatialConvolution(6, 12, 5, 5, device=dev)(x)
    x = nn.Tanh()(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2)(x)
    x = nn.Reshape((12 * 4 * 4,))(x)
    x = nn.Linear(12 * 4 * 4, 100, device=dev)(x)
    x = nn.Tanh()(x)
    x = nn.Linear(100, class_num, device=dev)(x)
    out = nn.LogSoftMax()(x)
    return nn.Graph(inp, out).reset(seed)
