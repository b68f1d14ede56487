"""prefill_issue_ms_per_ktok (ms/ktok): host time of the model's prefill
calls over the traced window (the program's `model.prefill` spans, wall
clock), summed, over thousands of prompt tokens prefilled. Beside
`prefill_ms_per_ktok` (CUDA events, whichever side is slower): a ratio
near 1 means the host's issuing sets the prefill's pace."""
from portbench.harness import hostspans


def read(rec):
    w = hostspans.window(rec)
    if not w:
        return None
    calls = hostspans.named(w, "model.prefill")
    tokens = sum(rec["trace"]["prefill_S"])
    if not calls or not tokens:
        return None
    return 1e3 * sum(s.dur for s in calls) / (tokens / 1000.0)
