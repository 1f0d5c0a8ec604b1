"""AlexNet (the port of ``bigdl_tpu/models/alexnet.py``, reference
``example/loadmodel/AlexNet.scala``): the Caffe variant, with grouped
convolutions and cross-map LRN, for 227 x 227 images (fc6 takes 256 x 6 x
6), and the one-weird-trick variant without either, for 224 x 224.

Each function returns a ``Sequential`` with the reference's children and
names in the reference's order (``convert.module_params_from_jax`` maps
its weights as they are), with seeded weights (``Module.reset(seed)``).
Images are NCHW. conv3-conv5 are 3x3 stride-1 pad-1 and run on the
hand-written kernels on the card, the grouped conv4 and conv5 once per
group (``nn/conv.py``); the 11x11 and 5x5 convolutions are ``F.conv2d``.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def _classifier(model, class_num, has_dropout, dev):
    model.add(nn.Flatten())
    model.add(nn.Linear(256 * 6 * 6, 4096, device=dev).set_name("fc6"))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, 4096, device=dev).set_name("fc7"))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, class_num, device=dev).set_name("fc8"))
    model.add(nn.LogSoftMax())
    return model


def AlexNet(class_num=1000, has_dropout=True, device=None, seed=1):
    """Caffe AlexNet (reference ``AlexNet.apply``)."""
    dev = resolve_device(device)

    def conv(*args, **kw):
        return nn.SpatialConvolution(*args, device=dev, **kw)

    model = (nn.Sequential()
             .add(conv(3, 96, 11, 11, 4, 4).set_name("conv1"))
             .add(nn.ReLU())
             .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1"))
             .add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
             .add(conv(96, 256, 5, 5, 1, 1, 2, 2, n_group=2)
                  .set_name("conv2"))
             .add(nn.ReLU())
             .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm2"))
             .add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
             .add(conv(256, 384, 3, 3, 1, 1, 1, 1).set_name("conv3"))
             .add(nn.ReLU())
             .add(conv(384, 384, 3, 3, 1, 1, 1, 1, n_group=2)
                  .set_name("conv4"))
             .add(nn.ReLU())
             .add(conv(384, 256, 3, 3, 1, 1, 1, 1, n_group=2)
                  .set_name("conv5"))
             .add(nn.ReLU())
             .add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5")))
    return _classifier(model, class_num, has_dropout, dev).reset(seed)


def AlexNet_OWT(class_num=1000, has_dropout=True, device=None, seed=1):
    """One-weird-trick AlexNet, no groups or LRN (reference
    ``AlexNet_OWT``)."""
    dev = resolve_device(device)

    def conv(*args, **kw):
        return nn.SpatialConvolution(*args, device=dev, **kw)

    model = (nn.Sequential()
             .add(conv(3, 64, 11, 11, 4, 4, 2, 2).set_name("conv1"))
             .add(nn.ReLU())
             .add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
             .add(conv(64, 192, 5, 5, 1, 1, 2, 2).set_name("conv2"))
             .add(nn.ReLU())
             .add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
             .add(conv(192, 384, 3, 3, 1, 1, 1, 1).set_name("conv3"))
             .add(nn.ReLU())
             .add(conv(384, 256, 3, 3, 1, 1, 1, 1).set_name("conv4"))
             .add(nn.ReLU())
             .add(conv(256, 256, 3, 3, 1, 1, 1, 1).set_name("conv5"))
             .add(nn.ReLU())
             .add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5")))
    return _classifier(model, class_num, has_dropout, dev).reset(seed)
