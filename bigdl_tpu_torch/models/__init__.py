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
from bigdl_tpu_torch.models.rnn import PTBModel, SimpleRNN
from bigdl_tpu_torch.models.routes import (conv_routes, layer_walk,
                                           model_flops, resnet_flops)
from bigdl_tpu_torch.models.transformer import (BERT, BertForMLM,
                                                SequenceParallelStep,
                                                TransformerEncoderLayer,
                                                bert_base,
                                                bert_mlm_flops_per_token,
                                                make_sp_train_step)
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["AlexNet", "AlexNet_OWT", "BERT", "BertForMLM", "GPT",
           "GPTForCausalLM", "Inception_v1", "Inception_v1_NoAuxClassifier",
           "Inception_v2", "LeNet5", "PTBModel", "ResNet", "SequenceParallelStep",
           "SimpleRNN",
           "TransformerDecoderBlock", "TransformerEncoderLayer",
           "VggForCifar10", "Vgg_16", "Vgg_19", "bert_base",
           "bert_mlm_flops_per_token", "conv_routes", "gpt2_small",
           "gpt_flops_per_token", "inception_module", "layer_walk",
           "lenet_graph", "make_sp_train_step", "model_flops",
           "prompt_bucket", "resnet_flops", "sample_logits"]
