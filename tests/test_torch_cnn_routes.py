"""The route table of ``bigdl_tpu_torch/models/routes.py``: the kernel
launches one training step of each image model makes, by path, counted
from its layers (the yardstick ``chip_smoke.py`` holds the card's launch
counters to), its layer walk, and its forward operations.

The counts: a 3x3 stride-1 pad-1 convolution launches its kernel once a
group forward (``i2c`` up to 64 input channels a group, else ``k9``) and
once a group for the input gradient (by its output channels), except
where its input depends on no parameter (VGG's first layer reads the
images); every other convolution is one ``F.conv2d``. In bfloat16 a
launch runs on the tensor cores when both channel counts are multiples
of 8 (and, for k9, the image is at most ``TC_K9_MAX_W`` wide), else on
the CUDA cores; in float32 always on the CUDA cores.
"""

import pytest
import torch

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import (AlexNet, AlexNet_OWT, Inception_v1,
                                    Inception_v1_NoAuxClassifier,
                                    Inception_v2, ResNet, Vgg_16, Vgg_19,
                                    VggForCifar10, conv_routes, layer_walk,
                                    model_flops, resnet_flops)


def _split(i2c_tc, i2c_simt, k9_tc, k9_simt, library):
    return {"i2c": {"tc": i2c_tc, "simt": i2c_simt},
            "k9": {"tc": k9_tc, "simt": k9_simt}, "library": library}


# (model function, image, float32 totals, bfloat16 split)
TABLES = {
    # 3 i2c forwards (3->64, 64->64, 64->128) and the 64->64 layer's input
    # gradient; the first layer's forward has 3 input channels, so it runs
    # on the CUDA cores in bfloat16; 10 k9 forwards and 11 input gradients
    "Vgg_16": (Vgg_16, 224, {"i2c": 4, "k9": 21, "library": 0},
               _split(3, 1, 21, 0, 0)),
    "Vgg_19": (Vgg_19, 224, {"i2c": 4, "k9": 27, "library": 0},
               _split(3, 1, 27, 0, 0)),
    # conv2/3x3 (64 -> 192 at 56²): forward i2c, input gradient k9; the
    # nine towers' 3x3s (Cin 96-192) k9 both ways; the 1x1, 5x5 and 7x7
    # convolutions, the aux heads' 1x1s included, on the library
    "Inception_v1": (Inception_v1, 224, {"i2c": 1, "k9": 19, "library": 49},
                     _split(1, 0, 19, 0, 49)),
    "Inception_v1_NoAuxClassifier": (
        Inception_v1_NoAuxClassifier, 224,
        {"i2c": 1, "k9": 19, "library": 47}, _split(1, 0, 19, 0, 47)),
    "Inception_v2": (Inception_v2, 224, {"i2c": 5, "k9": 13, "library": 42},
                     _split(5, 0, 13, 0, 42)),
    # conv3, and conv4 and conv5 once a group, forward and input gradient
    "AlexNet": (AlexNet, 227, {"i2c": 0, "k9": 10, "library": 2},
                _split(0, 0, 10, 0, 2)),
    "AlexNet_OWT": (AlexNet_OWT, 224, {"i2c": 0, "k9": 6, "library": 2},
                    _split(0, 0, 6, 0, 2)),
}


@pytest.fixture(scope="module")
def models():
    return {name: b(1000, device="cpu") for name, (b, _, _, _)
            in TABLES.items()}


@pytest.mark.parametrize("name", list(TABLES))
def test_route_tables(models, name):
    _, hw, totals, bf16 = TABLES[name]
    m = models[name]
    assert conv_routes(m, (hw, hw)) == totals
    assert conv_routes(m, (hw, hw), torch.bfloat16) == bf16
    f32 = conv_routes(m, (hw, hw), torch.float32)
    assert f32["i2c"]["tc"] == f32["k9"]["tc"] == 0
    assert {"i2c": f32["i2c"]["simt"], "k9": f32["k9"]["simt"],
            "library": f32["library"]} == totals


def test_resnet50_table_and_flops_unchanged():
    m = ResNet(class_num=1000, depth=50, format="NHWC", device="cpu")
    assert conv_routes(m) == {"i2c": 6, "k9": 20, "library": 40}
    assert conv_routes(m, dtype=torch.bfloat16) == _split(6, 0, 20, 0, 40)
    assert resnet_flops(m, (224, 224)) == model_flops(m) == 8_178_368_512


@pytest.mark.parametrize("name,hw,want", [
    ("Vgg_16", 224, 30_940_528_640), ("Inception_v1", 224, 3_182_088_192),
    ("AlexNet", 227, 1_448_813_632), ("AlexNet_OWT", 224, 1_428_376_960)])
def test_model_flops(models, name, hw, want):
    assert model_flops(models[name], (hw, hw)) == want


def test_vgg16_walk_shapes_and_first_layer():
    m = Vgg_16(1000, device="cpu")
    convs = [(c, hw, grad) for c, hw, grad in layer_walk(m, (224, 224))
             if isinstance(c, tnn.SpatialConvolution)]
    assert len(convs) == 13
    assert [(c.n_input_plane, hw[0]) for c, hw, _ in convs[:4]] == \
        [(3, 224), (64, 224), (64, 112), (128, 112)]
    assert [g for _, _, g in convs] == [False] + [True] * 12


def test_grouped_walk_counts_each_group():
    m = AlexNet(1000, device="cpu")
    convs = [(c.n_group, hw) for c, hw, _ in layer_walk(m, (227, 227))
             if isinstance(c, tnn.SpatialConvolution)]
    assert convs == [(1, (227, 227)), (2, (27, 27)), (1, (13, 13)),
                     (2, (13, 13)), (2, (13, 13))]


def test_vgg_cifar_and_lenet_walk():
    assert conv_routes(VggForCifar10(device="cpu"), (32, 32)) == \
        {"i2c": 4, "k9": 21, "library": 0}
    # a ConcatTable's children all read its input, as a Concat's do (the
    # RPN's two heads); a ParallelTable's read a table's entries
    walk = layer_walk(tnn.Sequential().add(tnn.ConcatTable().add(
        tnn.Identity()).add(tnn.ReLU())), (4, 4))
    assert [(type(m).__name__, hw) for m, hw, _ in walk] == \
        [("Identity", (4, 4)), ("ReLU", (4, 4))]
    with pytest.raises(TypeError, match="walk"):
        layer_walk(tnn.Sequential().add(tnn.ParallelTable().add(
            tnn.Identity())), (4, 4))


def test_forward_only_routes_drop_the_input_gradients():
    """``training=False``: one forward pass, a launch a 3x3 convolution
    (VGG's 13), none for an input gradient (12 in a step)."""
    m = VggForCifar10(device="cpu")
    fwd = conv_routes(m, (32, 32), training=False)
    step = conv_routes(m, (32, 32))
    assert fwd["i2c"] + fwd["k9"] == 13 and fwd["library"] == 0
    assert step["i2c"] + step["k9"] == 13 + 12
