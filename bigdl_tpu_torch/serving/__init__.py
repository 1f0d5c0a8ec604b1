from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.paging import (PageAllocator, PagedSlotManager,
                                            PagePoolExhausted)
from bigdl_tpu_torch.serving.scheduler import (DeadlineExceededError,
                                               EngineClosedError,
                                               EngineFailedError,
                                               QueueFullError, Request,
                                               RequestCancelledError)

__all__ = ["ServingEngine", "PageAllocator", "PagedSlotManager",
           "PagePoolExhausted", "Request", "QueueFullError",
           "EngineClosedError", "EngineFailedError",
           "RequestCancelledError", "DeadlineExceededError"]
