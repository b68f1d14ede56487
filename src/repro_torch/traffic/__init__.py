"""Serving traffic of the port: multi-tenant KV occupancy as a Stage-I
workload (port of the reference package's `repro/traffic`).

`generators` draws seeded request streams (shared-prefix families
included), `occupancy` composes them into time-resolved occupancy traces
(Stage-II compatible via `sim.trace.TraceBundle`), `controller` runs the
online power-gating policy against the live trace, and `campaign` sweeps
traffic intensity x model x (C, B) grids, its Stage-II legs on `device`.
"""
from repro_torch.traffic.generators import (  # noqa: F401
    WORKLOADS, LengthModel, RequestSpec, agentic_fanout, bursty,
    chat_sysprompt, diurnal, fewshot, generate, generate_workload,
    materialize_tokens, poisson, replay)
from repro_torch.traffic.occupancy import (  # noqa: F401
    SpecTrafficStats, TimingModel, TrafficSim, TrafficStats,
    simulate_prefix_traffic, simulate_spec_traffic, simulate_traffic,
    utilization_summary)
from repro_torch.traffic.controller import (  # noqa: F401
    ControllerComparison, ControllerConfig, OnlineResult, compare,
    compare_grid, simulate_online)
from repro_torch.traffic.campaign import (  # noqa: F401
    CampaignReport, CampaignRow, Scenario, fast_candidate_energies,
    run_campaign, run_scenario)
