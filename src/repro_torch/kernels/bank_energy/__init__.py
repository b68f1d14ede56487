from repro_torch.kernels.bank_energy.ops import (  # noqa: F401
    bank_activity_stats, exact_bank_stats)
from repro_torch.kernels.bank_energy.ref import (  # noqa: F401
    bank_energy_ref, exact_bank_stats_ref)
