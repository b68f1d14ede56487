"""batch_fill (%): tokens generated by decode steps over the steps' slot
capacity (steps x slots), from the batcher's `PagedStats` over the window.
Reads nothing where the window ran no decode chunk."""


def read(rec):
    st = rec["stats"]
    steps = st["chunks"] * rec["chunk_steps"]
    if not steps:
        return None
    return 100.0 * st["decode_tokens"] / (steps * rec["slots"])
