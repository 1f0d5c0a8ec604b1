from bigdl_tpu_torch.optim.methods import SGD, Adam, AdamW, OptimMethod
from bigdl_tpu_torch.optim.optimizer import (clip_by_global_norm,
                                             clip_by_value,
                                             make_loss_and_grads,
                                             make_train_step)
from bigdl_tpu_torch.optim.schedules import Default

__all__ = ["SGD", "Adam", "AdamW", "OptimMethod", "clip_by_global_norm",
           "clip_by_value", "make_loss_and_grads", "make_train_step",
           "Default"]
