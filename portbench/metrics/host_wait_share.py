"""host_wait_share (%): the share of the traced window the host spent
waiting on the card, in the program's `paged.sync` spans (the reads of an
admission's first token and of each chunk's tokens). `idle_share` is the
card waiting on the host; this is the converse, higher where the card
sets the pace."""
from portbench.harness import hostspans


def read(rec):
    w = hostspans.window(rec)
    if not w or rec["trace"]["window_s"] <= 0:
        return None
    wait = sum(s.dur for s in hostspans.named(w, hostspans.SYNC))
    return 100.0 * wait / rec["trace"]["window_s"]
