from bigdl_tpu_torch.serving.adapters import (AdapterColdError,
                                              AdapterLoadError, AdapterPool,
                                              AdapterPoolExhausted)
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
from bigdl_tpu_torch.serving.control import (AdmissionRejectedError,
                                             AutoScaler, ControlPolicy,
                                             FairQueue, RateLimitedError,
                                             TokenBucket)

__all__ = ["ServingEngine", "SlotManager", "PageAllocator", "PagedSlotManager",
           "HostPageTier", "HostTierCopier",
           "PagePoolExhausted", "Request", "QueueFullError",
           "EngineClosedError", "EngineFailedError",
           "RequestCancelledError", "DeadlineExceededError",
           "AdapterPool", "AdapterPoolExhausted", "AdapterColdError",
           "AdapterLoadError", "AdmissionRejectedError", "AutoScaler",
           "ControlPolicy", "FairQueue", "RateLimitedError", "TokenBucket",
           "EngineFleet"]


def __getattr__(name):
    # lazily: the router imports resilience.supervisor, which imports the
    # scheduler from this package
    if name == "EngineFleet":
        from bigdl_tpu_torch.serving.router import EngineFleet
        return EngineFleet
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
