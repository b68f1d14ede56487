"""mfu (%): the model FLOPs of every token the window processed (each
admitted prompt's prefill, each served decode token; `harness.counts`)
over the window's time on the host clock times the card's bf16 peak."""


def read(rec):
    pk = rec["peaks"]
    if not pk or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * pk["bf16_flops"])
