"""decode_issue_ms (ms): mean host time of one `decode_step_paged` call
over the traced window (the program's `model.decode_step` spans, wall
clock). Beside `decode_step_ms` (CUDA events, whichever side is slower):
a ratio near 1 means the host's issuing sets the decode step's pace."""
from portbench.harness import hostspans


def read(rec):
    w = hostspans.window(rec)
    calls = hostspans.named(w, "model.decode_step") if w else None
    if not calls:
        return None
    return 1e3 * sum(s.dur for s in calls) / len(calls)
