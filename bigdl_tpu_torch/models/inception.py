"""Inception-v1 (GoogLeNet) and v2 (the port of
``bigdl_tpu/models/inception.py``, reference
``models/inception/Inception_v1.scala:181`` and ``Inception_v2.scala``).

An inception module is a ``Concat`` over channels of four towers (1x1;
1x1 then 3x3; 1x1 then 5x5; a 3x3 max pool then 1x1), as in the
reference. Each model function returns the reference's tree of ``Sequential`` and
``Concat`` containers, children and names in the reference's order
(``convert.module_params_from_jax`` maps its weights as they are), with
seeded weights (``Module.reset(seed)``). Images are NCHW.

:func:`Inception_v1` has both auxiliary heads: its output is the three
heads' log-probabilities concatenated as ``[loss3 | loss2 | loss1]``,
(N, 3 * class_num); a ``ClassNLLCriterion``'s targets index the first
(main) slice, as the reference's ``Train.scala`` trains it.

The towers' 3x3 convolutions (stride 1, pad 1) and conv2/3x3 run on the
hand-written kernels on the card (``nn/conv.py``); the 1x1, 5x5 and 7x7
convolutions are ``F.conv2d``.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def inception_module(n_in, config, name="inception", with_bn=False,
                     device=None):
    """``config = ([1x1], [3x3 reduce, 3x3], [5x5 reduce, 5x5], [pool
    proj])`` (reference ``Inception_v1.scala`` inception())."""
    dev = resolve_device(device)

    def conv(n_i, n_o, k, pad=0):
        layers = [nn.SpatialConvolution(n_i, n_o, k, k, 1, 1, pad, pad,
                                        device=dev)]
        if with_bn:
            layers.append(nn.SpatialBatchNormalization(n_o, eps=1e-3,
                                                       device=dev))
        layers.append(nn.ReLU())
        return layers

    concat = nn.Concat(1)
    concat.add(nn.Sequential(*conv(n_in, config[0][0], 1)))
    concat.add(nn.Sequential(*(conv(n_in, config[1][0], 1)
                               + conv(config[1][0], config[1][1], 3, 1))))
    concat.add(nn.Sequential(*(conv(n_in, config[2][0], 1)
                               + conv(config[2][0], config[2][1], 5, 2))))
    concat.add(nn.Sequential(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
                             *conv(n_in, config[3][0], 1)))
    return concat.set_name(name)


def _stem_v1(dev):
    """conv1 to pool2 of Inception-v1 (224² in, 192 x 28² out)."""
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, device=dev)
                 .set_name("conv1/7x7_s2"))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(nn.SpatialConvolution(64, 64, 1, 1, device=dev)
                 .set_name("conv2/3x3_reduce"))
            .add(nn.ReLU())
            .add(nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1, device=dev)
                 .set_name("conv2/3x3"))
            .add(nn.ReLU())
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()))


def _pool():
    return nn.SpatialMaxPooling(3, 3, 2, 2).ceil()


def Inception_v1_NoAuxClassifier(class_num=1000, has_dropout=True,
                                 device=None, seed=1):
    """GoogLeNet's main branch alone (reference
    ``Inception_v1_NoAuxClassifier``)."""
    dev = resolve_device(device)

    def mod(n_in, cfg, name):
        return inception_module(n_in, cfg, name, device=dev)

    model = (_stem_v1(dev)
             .add(mod(192, ([64], [96, 128], [16, 32], [32]), "3a"))
             .add(mod(256, ([128], [128, 192], [32, 96], [64]), "3b"))
             .add(_pool())
             .add(mod(480, ([192], [96, 208], [16, 48], [64]), "4a"))
             .add(mod(512, ([160], [112, 224], [24, 64], [64]), "4b"))
             .add(mod(512, ([128], [128, 256], [24, 64], [64]), "4c"))
             .add(mod(512, ([112], [144, 288], [32, 64], [64]), "4d"))
             .add(mod(528, ([256], [160, 320], [32, 128], [128]), "4e"))
             .add(_pool())
             .add(mod(832, ([256], [160, 320], [32, 128], [128]), "5a"))
             .add(mod(832, ([384], [192, 384], [48, 128], [128]), "5b"))
             .add(nn.SpatialAveragePooling(7, 7, 1, 1)))
    if has_dropout:
        model.add(nn.Dropout(0.4))
    model.add(nn.Reshape((1024,)))
    model.add(nn.Linear(1024, class_num, device=dev)
              .set_name("loss3/classifier"))
    model.add(nn.LogSoftMax().set_name("loss3/loss3"))
    return model.reset(seed)


def Inception_v2(class_num=1000, device=None, seed=1):
    """BN-Inception-flavoured v2 (reference ``Inception_v2.scala``): the
    main trunk with BN after each convolution."""
    dev = resolve_device(device)

    def conv_bn(n_i, n_o, k, s=1, p=0):
        return [nn.SpatialConvolution(n_i, n_o, k, k, s, s, p, p,
                                      with_bias=False, device=dev),
                nn.SpatialBatchNormalization(n_o, eps=1e-3, device=dev),
                nn.ReLU()]

    def mod(n_in, cfg, name):
        return inception_module(n_in, cfg, name, True, device=dev)

    model = nn.Sequential(*conv_bn(3, 64, 7, 2, 3), _pool(),
                          *conv_bn(64, 64, 1), *conv_bn(64, 192, 3, 1, 1),
                          _pool())
    (model.add(mod(192, ([64], [64, 64], [64, 96], [32]), "3a"))
     .add(mod(256, ([64], [64, 96], [64, 96], [64]), "3b"))
     .add(_pool())
     .add(mod(320, ([224], [64, 96], [96, 128], [128]), "4a"))
     .add(mod(576, ([192], [96, 128], [96, 128], [128]), "4b"))
     .add(mod(576, ([160], [128, 160], [128, 160], [96]), "4c"))
     .add(mod(576, ([96], [128, 192], [160, 192], [96]), "4d"))
     .add(_pool())
     .add(mod(576, ([352], [192, 320], [160, 224], [128]), "5a"))
     .add(mod(1024, ([352], [192, 320], [192, 224], [128]), "5b"))
     .add(nn.SpatialAveragePooling(7, 7, 1, 1))
     .add(nn.Reshape((1024,)))
     .add(nn.Linear(1024, class_num, device=dev))
     .add(nn.LogSoftMax()))
    return model.reset(seed)


def Inception_v1(class_num=1000, has_dropout=True, device=None, seed=1):
    """GoogLeNet with its two auxiliary heads (reference
    ``Inception_v1.scala:181``; see module docstring): head slices [0:C]
    main, [C:2C] aux2, [2C:3C] aux1."""
    dev = resolve_device(device)

    def mod(n_in, cfg, name):
        return inception_module(n_in, cfg, name, device=dev)

    def drop(p):
        return nn.Dropout(p) if has_dropout else nn.Identity()

    feature1 = (_stem_v1(dev)
                .add(mod(192, ([64], [96, 128], [16, 32], [32]), "3a"))
                .add(mod(256, ([128], [128, 192], [32, 96], [64]), "3b"))
                .add(_pool())
                .add(mod(480, ([192], [96, 208], [16, 48], [64]), "4a")))

    def aux_head(n_in, prefix):
        return (nn.Sequential()
                .add(nn.SpatialAveragePooling(5, 5, 3, 3, ceil_mode=True))
                .add(nn.SpatialConvolution(n_in, 128, 1, 1, device=dev)
                     .set_name(prefix + "/conv"))
                .add(nn.ReLU())
                .add(nn.Reshape((128 * 4 * 4,)))
                .add(nn.Linear(128 * 4 * 4, 1024, device=dev)
                     .set_name(prefix + "/fc"))
                .add(nn.ReLU())
                .add(drop(0.7))
                .add(nn.Linear(1024, class_num, device=dev)
                     .set_name(prefix + "/classifier"))
                .add(nn.LogSoftMax()))

    output1 = aux_head(512, "loss1")
    feature2 = (nn.Sequential()
                .add(mod(512, ([160], [112, 224], [24, 64], [64]), "4b"))
                .add(mod(512, ([128], [128, 256], [24, 64], [64]), "4c"))
                .add(mod(512, ([112], [144, 288], [32, 64], [64]), "4d")))
    output2 = aux_head(528, "loss2")
    output3 = (nn.Sequential()
               .add(mod(528, ([256], [160, 320], [32, 128], [128]), "4e"))
               .add(_pool())
               .add(mod(832, ([256], [160, 320], [32, 128], [128]), "5a"))
               .add(mod(832, ([384], [192, 384], [48, 128], [128]), "5b"))
               .add(nn.SpatialAveragePooling(7, 7, 1, 1))
               .add(drop(0.4))
               .add(nn.Reshape((1024,)))
               .add(nn.Linear(1024, class_num, device=dev)
                    .set_name("loss3/classifier"))
               .add(nn.LogSoftMax()))
    split2 = nn.Concat(1).add(output3).add(output2)
    main_branch = nn.Sequential().add(feature2).add(split2)
    split1 = nn.Concat(1).add(main_branch).add(output1)
    return nn.Sequential().add(feature1).add(split1).reset(seed)
