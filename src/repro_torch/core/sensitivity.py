"""Drowsy (three-state ON/DROWSY/OFF) retention constants,
copied from the reference package's `repro/core/sensitivity.py`.

Drowsy mode (Flautner et al., ISCA'02 — the paper's ref [12]) drops an idle
bank to a retention voltage instead of fully gating it: most of its leakage
goes, its data stays, and it wakes in a few cycles. The batched engine
(`core.candidates.evaluate_candidates` with policy="drowsy") prices short
idle runs with these fractions.
"""
from __future__ import annotations

DROWSY_LEAK_FRACTION = 0.25          # retention-voltage leakage vs ON
DROWSY_SWITCH_FRACTION = 0.02        # transition energy vs full PG pair

