"""Serving traffic of the port: the seeded request generators
(`traffic.generators`, a copy of the reference's), shared-prefix families
included. The occupancy simulators, the controller and the campaign are not
ported yet."""
from repro_torch.traffic.generators import (  # noqa: F401
    WORKLOADS, LengthModel, RequestSpec, agentic_fanout, bursty,
    chat_sysprompt, diurnal, fewshot, generate, generate_workload,
    materialize_tokens, poisson, replay)
