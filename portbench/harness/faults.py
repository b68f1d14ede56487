"""Faults planted in the program's timed path, for the check to catch: each
is a `hook(model, batcher)` for `serve.run_cell`. The CPU tests plant them
in tiny cells; `calibrate.py --fault <name>` plants them at a cell's own
size on the card."""


def state_unchanged(model, batcher):
    """Every decode step hands back the paged state it was given: the K/V
    row each slot writes is put back as it was, and no position advances.
    Only those rows are saved, so the fault fits beside a full pool."""
    step = model.decode_step_paged

    def broken(params, cache, tokens):
        pos = cache["pos"].clone()
        table = cache["page_table"]
        pools = [t for e in cache["slots"] for t in e.values()
                 if t.dim() == 5]                 # (L, pages, K, rows, d)
        ps = pools[0].shape[3]
        col = (pos // ps).long().clamp(max=table.shape[1] - 1)
        page = table.gather(1, col[:, None])[:, 0].long()
        off = (pos % ps).long()
        saved = [t[:, page, :, off, :].clone() for t in pools]
        out = step(params, cache, tokens)
        for t, s in zip(pools, saved):
            t[:, page, :, off, :] = s
        cache["pos"] = pos
        return out
    model.decode_step_paged = broken


def half_batch(model, batcher):
    """Each decode step computes the first half of the slots and gives the
    second half the first half's logits."""
    step = model.decode_step_paged

    def broken(params, cache, tokens):
        logits, cache = step(params, cache, tokens)
        h = logits.shape[0] // 2
        logits[h:] = logits[:logits.shape[0] - h]
        return logits, cache
    model.decode_step_paged = broken


def token_altered(model, batcher):
    """Each prefill's logits are shifted by one entry, so the first token
    served is another than the model's choice."""
    prefill = model.prefill

    def broken(params, batch, cache_len):
        logits, cache = prefill(params, batch, cache_len)
        return logits.roll(1, dims=-1), cache
    model.prefill = broken


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                         token_altered)}
