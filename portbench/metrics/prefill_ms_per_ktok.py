"""prefill_ms_per_ktok (ms/ktok): device time of the model's `prefill`
calls in the window (CUDA events recorded on the stream before and after
each call), summed, over thousands of prompt tokens prefilled."""


def read(rec):
    spans = rec["spans"]["prefill"]
    tokens = sum(S for S, _ in spans)
    if not tokens:
        return None
    return sum(ms for _, ms in spans) / (tokens / 1000.0)
