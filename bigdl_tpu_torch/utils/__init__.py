from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.flags import get_flag

__all__ = ["get_flag", "resolve_device"]
