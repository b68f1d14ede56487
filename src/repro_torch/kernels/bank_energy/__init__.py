from repro_torch.kernels.bank_energy.ops import (  # noqa: F401
    bank_activity_stats, energy_plan, exact_bank_stats, running_time,
    walk_plan)
from repro_torch.kernels.bank_energy.ref import (  # noqa: F401
    bank_energy_ref, bank_energy_tiled_ref, exact_bank_stats_chunked_ref,
    exact_bank_stats_ref)
