"""Every constructor of the port that takes ``device`` resolves it through
``utils.device.resolve_device``: ``None`` means the card, so without one
(as here) it raises naming ``device='cpu'`` instead of building on the CPU
by mistake; given ``device="cpu"`` it builds there."""

import pytest
import torch

from bigdl_tpu_torch.models import GPT, ResNet, TransformerDecoderBlock
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import (BatchNormalization, LayerNormalization,
                                Linear, SpatialBatchNormalization,
                                SpatialConvolution)
from bigdl_tpu_torch.nn.quantized import Int8Linear
from bigdl_tpu_torch.parallel.sequence import MultiHeadAttention

BUILDERS = {
    "GPT": lambda **kw: GPT(vocab_size=16, hidden_size=8, n_layers=1,
                            n_heads=2, max_position=8, **kw),
    "GPTForCausalLM": lambda **kw: GPTForCausalLM(
        vocab_size=16, hidden_size=8, n_layers=1, n_heads=2, max_position=8,
        **kw),
    "TransformerDecoderBlock": lambda **kw: TransformerDecoderBlock(8, 2,
                                                                    **kw),
    "MultiHeadAttention": lambda **kw: MultiHeadAttention(8, 2, **kw),
    "Linear": lambda **kw: Linear(4, 3, **kw),
    "Int8Linear": lambda **kw: Int8Linear(4, 3, **kw),
    "LayerNormalization": lambda **kw: LayerNormalization(4, **kw),
    "BatchNormalization": lambda **kw: BatchNormalization(4, **kw),
    "SpatialBatchNormalization": lambda **kw: SpatialBatchNormalization(
        4, format="NHWC", **kw),
    "SpatialConvolution": lambda **kw: SpatialConvolution(3, 4, 3, 3, **kw),
    "ResNet": lambda **kw: ResNet(class_num=10, depth=20,
                                  data_set="CIFAR-10", format="NHWC", **kw),
}


@pytest.fixture
def no_card(monkeypatch):
    """The machine as a CPU-only one, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_no_device_means_the_card_and_raises_without_one(name, no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BUILDERS[name]()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_device_cpu_builds_on_the_cpu(name):
    module = BUILDERS[name](device="cpu")
    tensors = list(module.parameters()) + list(module.buffers())
    assert tensors and all(t.device.type == "cpu" for t in tensors)
