"""VGG (the port of ``bigdl_tpu/models/vgg.py``, reference
``models/vgg/VggForCifar10.scala`` and ``example/loadmodel``'s
Vgg_16/Vgg_19).

Each model function returns a ``Sequential`` with the reference's children in
the reference's order, so ``convert.module_params_from_jax`` carries its
weights across as they are, and seeded weights of its own
(``Module.reset(seed)``). Images are NCHW, as in the reference; fed in
``torch.channels_last`` memory order they reach the 3x3 kernels without a
copy. Every convolution is 3x3, stride 1, pad 1: all of them run on the
hand-written kernels on the card (``nn/conv.py``), VGG-16's first at 224²
with 3 input channels.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def _conv_relu(seq, n_in, n_out, dev, with_bn=True):
    seq.add(nn.SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, device=dev))
    if with_bn:
        seq.add(nn.SpatialBatchNormalization(n_out, eps=1e-3, device=dev))
    seq.add(nn.ReLU())
    return n_out


def VggForCifar10(class_num=10, has_dropout=True, device=None, seed=1):
    """VGG with BN and dropout for 32 x 32 images (reference
    ``models/vgg/VggForCifar10.scala``)."""
    dev = resolve_device(device)
    model = nn.Sequential()
    n_in = 3
    cfg = [64, "D", 64, "M", 128, "D", 128, "M", 256, "D", 256, "D", 256,
           "M", 512, "D", 512, "D", 512, "M", 512, "D", 512, "D", 512, "M"]
    drop_ps = iter([0.3, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4])
    for c in cfg:
        if c == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
        elif c == "D":
            if has_dropout:
                model.add(nn.Dropout(next(drop_ps)))
        else:
            n_in = _conv_relu(model, n_in, c, dev)
    model.add(nn.Reshape((512,)))
    model.add(nn.Linear(512, 512, device=dev))
    model.add(nn.BatchNormalization(512, device=dev))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5))
    model.add(nn.Linear(512, class_num, device=dev))
    model.add(nn.LogSoftMax())
    return model.reset(seed)


def _vgg_blocks(cfg, class_num, device, seed):
    dev = resolve_device(device)
    model = nn.Sequential()
    n_in = 3
    for c in cfg:
        if c == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            n_in = _conv_relu(model, n_in, c, dev, with_bn=False)
    model.add(nn.Reshape((512 * 7 * 7,)))
    model.add(nn.Linear(512 * 7 * 7, 4096, device=dev))
    model.add(nn.ReLU())
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, 4096, device=dev))
    model.add(nn.ReLU())
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, class_num, device=dev))
    model.add(nn.LogSoftMax())
    return model.reset(seed)


def Vgg_16(class_num=1000, device=None, seed=1):
    """VGG-16 for 224 x 224 images."""
    return _vgg_blocks([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                        512, 512, 512, "M", 512, 512, 512, "M"], class_num,
                       device, seed)


def Vgg_19(class_num=1000, device=None, seed=1):
    """VGG-19 for 224 x 224 images."""
    return _vgg_blocks([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                        512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
                       class_num, device, seed)
