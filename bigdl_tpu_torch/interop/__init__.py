"""bigdl_tpu_torch.interop — model-format loaders and savers (the port of
``bigdl_tpu.interop``: reference ``utils/caffe``, ``utils/tf``,
``utils/TorchFile.scala``). ``TFTrainingSession`` is in
``interop.tf_session``, as in the reference. The TFRecord readers
(``interop/tf_record.py``) wait for ROADMAP A.11(d)(2)(b); the Keras
loader is not ported yet."""

from bigdl_tpu_torch.interop.torch_file import load_torch, save_torch  # noqa: F401
from bigdl_tpu_torch.interop.caffe import CaffeLoader, load_caffe  # noqa: F401
from bigdl_tpu_torch.interop.tf_loader import TensorflowLoader, load_tf  # noqa: F401
from bigdl_tpu_torch.interop.savers import (CaffePersister,  # noqa: F401
                                            TensorflowSaver, save_caffe,
                                            save_tf)

__all__ = ["CaffeLoader", "CaffePersister", "TensorflowLoader",
           "TensorflowSaver", "load_caffe", "load_tf", "load_torch",
           "save_caffe", "save_tf", "save_torch"]
