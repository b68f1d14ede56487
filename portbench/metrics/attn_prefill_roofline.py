"""attn_prefill_roofline (%): kernel 2 (`csrc/flash_attention.cu`) against
its roofline over the traced window. The ideal time of each call is the
larger of its causal FLOPs over the bf16 peak and its bytes (q, k, v read
once, o written once) over HBM bandwidth, one call per layer per prefill
(`harness.counts`); the kernel's time is the device time of the events of
its two kernels, by name, in the trace."""
from portbench.harness import counts

KERNELS = ("flash_tc_kernel", "flash_fwd_kernel")


def read(rec):
    tr, pk, s = rec.get("trace"), rec["peaks"], rec["shape"]
    if not tr or not pk or not tr["prefill_S"]:
        return None
    t = sum(v[0] for n, v in tr["kernels"].items()
            if any(k in n for k in KERNELS))
    if t <= 0:
        return None
    ideal = s.layers * sum(
        counts.ideal_s(counts.attn_prefill_flops(s, S),
                       counts.attn_prefill_bytes(s, S), pk)
        for S in tr["prefill_S"])
    return 100.0 * ideal / t
