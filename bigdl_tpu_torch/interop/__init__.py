"""bigdl_tpu_torch.interop — model-format loaders and savers (the port of
``bigdl_tpu.interop``'s Caffe and Torch7 halves: reference ``utils/caffe``,
``utils/TorchFile.scala``). The TensorFlow graph loader and saver, the
Keras loader and the TFRecord readers are not ported yet."""

from bigdl_tpu_torch.interop.torch_file import load_torch, save_torch  # noqa: F401
from bigdl_tpu_torch.interop.caffe import CaffeLoader, load_caffe  # noqa: F401
from bigdl_tpu_torch.interop.savers import CaffePersister, save_caffe  # noqa: F401

__all__ = ["CaffeLoader", "CaffePersister", "load_caffe", "load_torch",
           "save_caffe", "save_torch"]
