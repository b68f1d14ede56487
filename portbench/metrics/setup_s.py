"""`setup_s`: process start to the first timed admission (imports, the
kernel build of a checkout's first run, weights, page pool, warm-up)."""


def read(rec):
    return rec["setup_s"]
