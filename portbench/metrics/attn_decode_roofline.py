"""attn_decode_roofline (%): kernel 1 (`csrc/paged_gqa_decode.cu`, the
split path of `csrc/decode_attention.cuh`) against its roofline over the
traced window. The ideal time of each call is the larger of its FLOPs over
the bf16 peak and its bytes (the live K and V rows of each active slot,
every slot's query and output, the page table and lengths) over HBM
bandwidth, one call per layer per decode step (`harness.counts`); the
kernel's time is the device time of its split kernel over paged rows and
of the merge kernel, by name. The merge kernel is shared with kernels 6 and
7: this reader is for cells that run neither (no speculation, no dense
decode)."""
from portbench.harness import counts


def _kernel1(name):
    return ("decode_split_kernel" in name and "PagedRows" in name) \
        or "decode_merge_kernel" in name


def read(rec):
    tr, pk, s = rec.get("trace"), rec["peaks"], rec["shape"]
    if not tr or not pk or not tr["decode_rows"]:
        return None
    t = sum(v[0] for n, v in tr["kernels"].items() if _kernel1(n))
    if t <= 0:
        return None
    ideal = s.layers * sum(
        counts.ideal_s(counts.attn_decode_flops(s, rows),
                       counts.attn_decode_bytes(s, rows, rec["slots"],
                                                rec["table_pages"]), pk)
        for rows in tr["decode_rows"])
    return 100.0 * ideal / t
