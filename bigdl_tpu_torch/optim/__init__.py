from bigdl_tpu_torch.optim.evaluator import (DistriPredictor,
                                             DistriValidator, Evaluator,
                                             LocalValidator, Predictor,
                                             Validator)
from bigdl_tpu_torch.optim.methods import (LBFGS, SGD, Adadelta, Adagrad,
                                           Adam, Adamax, AdamW, Ftrl,
                                           OptimMethod, RMSprop)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             clip_by_global_norm,
                                             clip_by_value,
                                             make_loss_and_grads,
                                             make_train_loop,
                                             make_train_step)
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer)
from bigdl_tpu_torch.optim.schedules import (Default, EpochDecay,
                                             EpochSchedule, EpochStep,
                                             Exponential, MultiStep,
                                             NaturalExp, Plateau, Poly,
                                             Regime, SequentialSchedule,
                                             Step, Warmup)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (MAE, AccuracyResult, Loss,
                                              LossResult, Top1Accuracy,
                                              Top5Accuracy, TreeNNAccuracy,
                                              ValidationMethod)

__all__ = ["LBFGS", "MAE", "SGD", "AccuracyResult", "Adadelta", "Adagrad",
           "Adam", "Adamax", "AdamW", "Default", "DistriPredictor",
           "DistriValidator", "EpochDecay",
           "EpochSchedule", "EpochStep", "Evaluator", "Exponential", "Ftrl",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LocalOptimizer", "LocalValidator", "Loss", "LossResult",
           "MultiStep", "NaturalExp", "OptimMethod", "Optimizer", "Plateau",
           "Poly", "Predictor", "RMSprop", "Regime", "Regularizer",
           "SequentialSchedule", "Step", "Top1Accuracy", "Top5Accuracy",
           "TreeNNAccuracy", "Trigger", "ValidationMethod", "Validator", "Warmup",
           "clip_by_global_norm", "clip_by_value", "make_loss_and_grads",
           "make_train_loop", "make_train_step"]
