"""batcher_host_ms (ms): the paged batcher's own host time per
admission-and-chunk cycle over the traced window: the program's
`paged.admit` and `paged.decode_chunk` spans less the model calls
(`model.*`) and the host's waits on the card (`paged.sync`) inside them.
Page writes, page tables, queues and the host state pushed each chunk
count as the batcher's."""
from portbench.harness import hostspans


def read(rec):
    w = hostspans.window(rec)
    if not w:
        return None
    roots = [s for s in w if s.parent is None and s.name in hostspans.BATCHER]
    cycles = sum(s.name == hostspans.CYCLE for s in roots)
    if not cycles:
        return None
    inner = sum(s.dur for s in w if hostspans.outer_cost(s)
                and hostspans.root(s).name in hostspans.BATCHER)
    return 1e3 * (sum(s.dur for s in roots) - inner) / cycles
