from repro_torch.serve.paged import (  # noqa: F401
    OutOfPages, PageAllocator, PagedContinuousBatcher, PagedKVLedger,
    PagedStats, page_bytes, pages_for)
from repro_torch.serve.scheduler import (  # noqa: F401
    AdmissionQueue, Request, SchedulerStats)
