"""bigdl_tpu_torch.interop — model-format loaders and savers and the
TFRecord readers (the port of ``bigdl_tpu.interop``: reference
``utils/caffe``, ``utils/tf``, ``utils/TorchFile.scala``).
``TFTrainingSession`` is in ``interop.tf_session``, as in the reference.
The Keras loader is not ported yet."""

from bigdl_tpu_torch.interop.torch_file import load_torch, save_torch  # noqa: F401
from bigdl_tpu_torch.interop.caffe import CaffeLoader, load_caffe  # noqa: F401
from bigdl_tpu_torch.interop.tf_loader import TensorflowLoader, load_tf  # noqa: F401
from bigdl_tpu_torch.interop.savers import (CaffePersister,  # noqa: F401
                                            TensorflowSaver, save_caffe,
                                            save_tf)
from bigdl_tpu_torch.interop.tf_record import (  # noqa: F401
    FixedLengthRecordReader, TFRecordWriter, build_example, parse_example,
    read_tf_examples, tf_record_iterator)

__all__ = ["CaffeLoader", "CaffePersister", "FixedLengthRecordReader",
           "TFRecordWriter", "TensorflowLoader", "TensorflowSaver",
           "build_example", "load_caffe", "load_tf", "load_torch",
           "parse_example", "read_tf_examples", "save_caffe", "save_tf",
           "save_torch", "tf_record_iterator"]
