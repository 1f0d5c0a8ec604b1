from bigdl_tpu_torch.models.gpt import (GPT, GPTForCausalLM,
                                        TransformerDecoderBlock, gpt2_small,
                                        gpt_flops_per_token, prompt_bucket,
                                        sample_logits)
from bigdl_tpu_torch.models.lenet import LeNet5, lenet_graph
from bigdl_tpu_torch.models.resnet import ResNet, conv_routes, resnet_flops

__all__ = ["GPT", "GPTForCausalLM", "LeNet5", "TransformerDecoderBlock",
           "ResNet", "lenet_graph",
           "conv_routes", "gpt2_small", "gpt_flops_per_token",
           "prompt_bucket", "resnet_flops", "sample_logits"]
