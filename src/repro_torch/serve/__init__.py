from repro_torch.serve.engine import (  # noqa: F401
    BatchedServer, ServeConfig, ServeStats)
from repro_torch.serve.paged import (  # noqa: F401
    OutOfPages, PageAllocator, PagedContinuousBatcher, PagedKVLedger,
    PagedStats, page_bytes, pages_for)
from repro_torch.serve.prefix import (  # noqa: F401
    PrefixMatch, RadixPrefixIndex, SharedKVLedger, SharedPageAllocator)
from repro_torch.serve.scheduler import (  # noqa: F401
    AdmissionQueue, ContinuousBatcher, Request, SchedulerStats, kv_bytes_at,
    kv_slot_budget, slot_state_bytes)
