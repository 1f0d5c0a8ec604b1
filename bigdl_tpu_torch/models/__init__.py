from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNet_OWT
from bigdl_tpu_torch.models.gpt import (GPT, GPTForCausalLM,
                                        TransformerDecoderBlock, gpt2_small,
                                        gpt_flops_per_token, prompt_bucket,
                                        sample_logits)
from bigdl_tpu_torch.models.inception import (Inception_v1,
                                              Inception_v1_NoAuxClassifier,
                                              Inception_v2, inception_module)
from bigdl_tpu_torch.models.lenet import LeNet5, lenet_graph
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.routes import (conv_routes, layer_walk,
                                           model_flops, resnet_flops)
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["AlexNet", "AlexNet_OWT", "GPT", "GPTForCausalLM",
           "Inception_v1", "Inception_v1_NoAuxClassifier", "Inception_v2",
           "LeNet5", "ResNet", "TransformerDecoderBlock", "VggForCifar10",
           "Vgg_16", "Vgg_19", "conv_routes", "gpt2_small",
           "gpt_flops_per_token", "inception_module", "layer_walk",
           "lenet_graph", "model_flops", "prompt_bucket", "resnet_flops",
           "sample_logits"]
