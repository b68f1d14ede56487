"""decode_step_ms (ms): mean time of one `decode_step_paged` call in the
window, from CUDA events recorded on the stream before and after each
call."""


def read(rec):
    spans = rec["spans"]["decode"]
    if not spans:
        return None
    return sum(spans) / len(spans)
