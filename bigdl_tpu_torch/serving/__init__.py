from bigdl_tpu_torch.serving.adapters import AdapterLoadError
from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.host_tier import HostPageTier, HostTierCopier
from bigdl_tpu_torch.serving.paging import (PageAllocator, PagedSlotManager,
                                            PagePoolExhausted)
from bigdl_tpu_torch.serving.scheduler import (DeadlineExceededError,
                                               EngineClosedError,
                                               EngineFailedError,
                                               QueueFullError, Request,
                                               RequestCancelledError)
from bigdl_tpu_torch.serving.slots import SlotManager

__all__ = ["ServingEngine", "SlotManager", "PageAllocator", "PagedSlotManager",
           "HostPageTier", "HostTierCopier",
           "PagePoolExhausted", "Request", "QueueFullError",
           "EngineClosedError", "EngineFailedError",
           "RequestCancelledError", "DeadlineExceededError",
           "AdapterLoadError"]
