"""One run of a serving cell: set-up, the measured window, the traced
cycles, and the correctness check, over the port's paged serving path.

The window drives `repro_torch.serve.paged.PagedContinuousBatcher`
(`submit` and `run`) over a full-width `repro_torch.models.DecoderLM`
whose weights the harness made from the seed. Before every
admission-and-chunk cycle (`run(max_chunks=1)`) the traffic is fed: an
offline backlog tops the queue up to one full refill (`slots` requests),
so every slot that frees is refilled at the next admission; an open loop
submits every request due by then. The window closes at the end of the
first cycle that ends `seconds` after it opened; `tok_s` is all the
window's work (prompt tokens of every admitted request, plus every token
served) over all its time. Each request's time to first token runs from
its due time to the end of the cycle that served its first token; an open
loop serves on after the window until every request due in it has one.

With `trace`, CUDA events around every `prefill` and
`decode_step_paged` call time the model layer through the window, and
after it `profile_cycles` more cycles run under torch.profiler: the traced
window of the device metrics. The per-layer readers
(`portbench/metrics/<name>.py`) read the record this module builds."""
from __future__ import annotations

import dataclasses
import gc
import resource
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from portbench.harness import check, counts, devtrace
from portbench.harness.traffic import length_pairs, requests
from portbench.harness.weights import make_weights, program_params
from portbench.reference.decoder import shape_of

# the kernels a serving cell runs (`repro_torch/csrc/<stem>.cu`)
KERNEL_SOURCES = ("flash_attention", "paged_gqa_decode")
# how long an open loop serves on after its window, for the requests due
# in it that have no token yet
DRAIN_S = 60.0


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def program_arch(conf: dict):
    """The program's registered config named by the configuration file,
    with the LM head tied or not as the file says (an option of the
    program), held to the file's sizes, so the program runs what the file
    says."""
    from repro_torch.configs import get_arch
    arch = dataclasses.replace(
        get_arch(conf["arch"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]))
    s = shape_of(conf)
    want = {"num_layers": s.layers, "d_model": s.d, "num_heads": s.heads,
            "num_kv_heads": s.kv_heads, "head_dim": s.head_dim,
            "d_ff": s.ffn, "vocab_size": s.vocab,
            "tie_embeddings": bool(conf["tie_word_embeddings"])}
    if s.family == "qwen2":
        want.update(ffn_kind="swiglu", norm="rmsnorm", pos_emb="rope",
                    attn_bias=True, rope_theta=s.rope_theta)
    else:
        want.update(ffn_kind="gelu_mlp", norm="layernorm",
                    pos_emb="learned", attn_bias=False,
                    max_seq_len=s.positions)
    bad = {k: (getattr(arch, k), v) for k, v in want.items()
           if getattr(arch, k) != v}
    if bad:
        raise ValueError(f"program config {arch.name} differs from the "
                         f"configuration file: {bad}")
    return arch


class Spans:
    """CUDA-event spans around the model's `prefill` and
    `decode_step_paged` calls (the program is handed wrapped methods);
    while `tracing`, each call's shape too: the prompt length, and the
    slots' positions and liveness as the decode step receives them."""

    def __init__(self, model, cuda: bool):
        from torch.profiler import record_function
        self.cuda = cuda
        self.tracing = False
        self.prefill: list = []          # (S, start, end)
        self.decode: list = []           # (start, end)
        self.traced_prefill: List[int] = []
        self.traced_decode: list = []    # (pos, active) device copies
        prefill, decode = model.prefill, model.decode_step_paged

        def timed_prefill(params, batch, cache_len):
            S = int(batch["tokens"].shape[1])
            a = self._mark()
            with record_function("portbench.prefill"):
                out = prefill(params, batch, cache_len)
            self.prefill.append((S, a, self._mark()))
            if self.tracing:
                self.traced_prefill.append(S)
            return out

        def timed_decode(params, cache, tokens):
            if self.tracing:
                self.traced_decode.append((cache["pos"].clone(),
                                           cache["active"].clone()))
            a = self._mark()
            with record_function("portbench.decode_step"):
                out = decode(params, cache, tokens)
            self.decode.append((a, self._mark()))
            return out

        model.prefill = timed_prefill
        model.decode_step_paged = timed_decode

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def read(self) -> dict:
        """Span times in ms, read once the device has finished."""
        return {"prefill": [(S, self._ms(a, b)) for S, a, b in self.prefill],
                "decode": [self._ms(a, b) for a, b in self.decode]}

    def traced_rows(self) -> List[List[int]]:
        """Keys attended by each active slot, per traced decode step."""
        return [(p[a].long() + 1).tolist() for p, a in
                ((p.cpu(), a.cpu()) for p, a in self.traced_decode)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def thread_cpu_s() -> float:
    """CPU seconds of the calling thread: over the window, how much of it
    the host thread that drives the card spent computing."""
    ru = resource.getrusage(getattr(resource, "RUSAGE_THREAD",
                                    resource.RUSAGE_SELF))
    return ru.ru_utime + ru.ru_stime


def _stat(b) -> dict:
    st = b.stats
    return {"decode_tokens": st.decode_steps, "chunks": st.chunks}


def window_flops(shape, reqs) -> int:
    """Model FLOPs of the admitted requests' prefills and of every decode
    token they were served."""
    total = 0
    for r in reqs:
        n, S = len(r.output), len(r.tokens)
        if n:
            total += counts.prefill_flops(shape, S)
            total += sum(counts.decode_flops(shape, S + j)
                         for j in range(1, n))
    return total


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: Optional[float] = None, arch=None,
             hook: Optional[Callable] = None, control: bool = False,
             cycles: Optional[int] = None) -> dict:
    """One run of `cell`. Returns the measured numbers, the record the
    metrics' readers take, and the correctness checks. `arch` replaces
    the registered program config (tests run reduced ones); `hook(model,
    batcher)` runs once both exist (tests break the path through it);
    `control` also reads the float8 control's numbers on the same sample
    (`control`), for setting limits: the benchmark's runs do not.
    `cycles` closes the window after that many cycles instead of after
    `seconds` (the same work on any host, for tests)."""
    from repro_torch.kernels import build
    from repro_torch.models import DecoderLM
    from repro_torch.serve.paged import PagedContinuousBatcher
    from repro_torch.serve.scheduler import Request

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    conf, wl, mix = cell.config, cell.workload, cell.traffic
    shape = shape_of(conf)
    arch = program_arch(conf) if arch is None else arch
    build_s = 0.0
    if cuda:
        t = time.perf_counter()
        build.build_all(KERNEL_SOURCES)
        build_s = time.perf_counter() - t
    w = make_weights(shape, seed, device, rows=arch.padded_vocab)
    params = program_params(arch, w)
    model = DecoderLM(arch, compute_dtype=torch.bfloat16, device=device)
    slots, steps = int(wl["slots"]), int(wl["chunk_steps"])
    batcher = PagedContinuousBatcher(
        model, params, num_slots=slots, page_size=int(conf["page_size"]),
        num_pages=int(wl["pool_pages"]), chunk_steps=steps,
        kv_dtype=conf["kv_dtype"])
    spans = Spans(model, cuda) if trace else None
    if hook is not None:
        hook(model, batcher)

    # warm-up: the mix's shortest and longest prompts, one decode chunk
    pairs = length_pairs(mix)
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x3a7])
    for rid, s in enumerate((int(pairs[:, 0].min()), int(pairs[:, 0].max()))):
        batcher.submit(Request(rid=-1 - rid, tokens=rng.integers(
            0, shape.vocab, size=s), max_new_tokens=steps + 1))
    batcher.run()
    _sync(device)
    if spans is not None:
        spans.prefill.clear()
        spans.decode.clear()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (kernel build {build_s:.3f} s)")

    # the measured window
    source = requests(mix, seed, shape.vocab)
    backlogged = mix["arrivals"] == "backlog"
    reqs: list = []
    finished: list = []
    waiting: list = []    # (request, host time due): no token served yet
    ttft: list = []       # seconds from due to the end of the first cycle
    nxt = None            # the next request of an open loop, not yet due

    def submit(due_t, toks, n):
        r = Request(rid=len(reqs), tokens=toks, max_new_tokens=n)
        reqs.append(r)
        waiting.append((r, due_t))
        batcher.submit(r)

    def feed():
        """A backlog: the queue topped up to one refill. An open loop:
        every request due by now submitted, after waiting for the next
        one when nothing is left to serve."""
        nonlocal nxt
        if backlogged:
            while len(batcher.queue) < slots:
                _, toks, n = next(source)
                submit(time.perf_counter(), toks, n)
            return
        nxt = next(source) if nxt is None else nxt
        idle = not batcher.queue and all(x is None for x in batcher.slots)
        wait = t0 + nxt[0] - time.perf_counter()
        if idle and wait > 0:
            time.sleep(wait)
        now = time.perf_counter()
        while t0 + nxt[0] <= now:
            submit(t0 + nxt[0], nxt[1], nxt[2])
            nxt = next(source)

    def cycle() -> list:
        """One admission-and-chunk cycle; the first tokens it served
        reach the host at its end."""
        out = batcher.run(max_chunks=1)
        t = time.perf_counter()
        still = []
        for r, due_t in waiting:
            if r.output:
                ttft.append(t - due_t)
            else:
                still.append((r, due_t))
        waiting[:] = still
        return out

    s0 = _stat(batcher)
    c0 = thread_cpu_s()
    t0 = time.perf_counter()
    n = 0
    while True:
        feed()
        finished += cycle()
        n += 1
        if (n >= cycles if cycles is not None
                else time.perf_counter() - t0 >= seconds):
            break
    window_s = time.perf_counter() - t0
    cpu_s = thread_cpu_s() - c0
    log(f"host thread busy {cpu_s:.2f} cpu-s of the window "
        f"({100 * cpu_s / window_s:.1f}%)")
    s1 = _stat(batcher)
    admitted = [r for r in reqs if r.output]
    prompt_tok = sum(len(r.tokens) for r in admitted)
    served_tok = sum(len(r.output) for r in reqs)
    tok_s = (prompt_tok + served_tok) / window_s
    log(f"window {window_s:.3f} s: {len(admitted)} admitted, "
        f"{len(finished)} finished, {prompt_tok} prompt + {served_tok} "
        f"served tokens, {tok_s:.1f} tokens/s; page pool peak "
        f"{batcher.stats.peak_pages} of {wl['pool_pages']} pages")
    if not backlogged:
        # an open loop's tail counts every request due in the window: serve
        # on, with nothing new submitted, until each has its first token
        t = time.perf_counter()
        while waiting and time.perf_counter() - t < DRAIN_S:
            finished += cycle()
        if waiting:
            log(f"{len(waiting)} requests due in the window had no token "
                f"{DRAIN_S} s after it closed")
            ttft += [float("inf")] * len(waiting)

    record = {"shape": shape, "slots": slots, "chunk_steps": steps,
              "table_pages": batcher.max_pages_per_slot,
              "window_s": window_s, "tok_s": tok_s, "setup_s": setup_s,
              "ttft_s": ttft, "pool_pages": int(wl["pool_pages"]),
              "pool_peak_pages": batcher.stats.peak_pages,
              "flops": window_flops(shape, reqs),
              "stats": {k: s1[k] - s0[k] for k in s1},
              "peaks": (counts.peaks(torch.cuda.get_device_name(0))
                        if cuda else None)}
    if trace:
        _sync(device)
        record["spans"] = spans.read()
        finished += _traced_cycles(batcher, spans, feed, cycle, wl, device,
                                   record)

    # the pages are read from slots in flight: where the last cycle freed
    # every slot (all its requests done at once), serve on until one holds
    for _ in range(8):
        if any(x is not None for x in batcher.slots):
            break
        feed()
        finished += cycle()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    held = page_rows(batcher, seed)
    done = [(r.tokens, list(r.output)) for r in finished]
    mismatch = sum(len(r.output) != r.max_new_tokens for r in finished)
    del batcher, model, params, spans, reqs, finished
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the program's state is freed
    ck = wl["check"]
    pick = check.sample(done, seed, ck["sample_tokens"], ck["max_requests"])
    t = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            g = [check.gaps(shape, w, *done[i]) for i in pick]
            cg = [check.control_gaps(shape, w, *done[i]) for i in pick
                  ] if control else []
            kv = [check.kv_err(shape, w, *h) for h in held]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    values = {"len_mismatch": mismatch, **check.gap_numbers(g)}
    if kv:
        values["kv_err"] = max(kv)
    checks = check.judge(values, ck["limits"])
    served = sum(len(done[i][1]) for i in pick)
    log(f"reference over {len(pick)} requests, {served} served tokens: "
        f"{time.perf_counter() - t:.3f} s")
    return {"correct": check.passed(checks), "attempted": len(admitted),
            "readings": values, "control": check.gap_numbers(cg),
            "sample_tokens": served,
            "failed": mismatch, "tok_s": tok_s, "setup_s": setup_s,
            "memory_peak_bytes": int(peak), "record": record,
            "checks": checks}


def _rows(pool: torch.Tensor, pages, n: int) -> torch.Tensor:
    """The first `n` rows held in `pages` of one layer's pool (N, K, ps, d),
    as (n, K, d); fp8 pools hold E4M3 codes."""
    x = pool[torch.as_tensor(pages, device=pool.device).long()]
    P, K, ps, d = x.shape
    x = x.transpose(1, 2).reshape(P * ps, K, d)[:n]
    if x.dtype == torch.uint8:
        x = x.view(torch.float8_e4m3fn)
    return x.float()


def page_rows(batcher, seed: int, n: int = 2) -> list:
    """(tokens, K rows, V rows) of the first layer, as held in the pages of
    up to `n` slots still active: the one with the most rows and others
    drawn from `seed`. A slot with p prompt tokens and o served ones holds
    p + o - 1 rows (the last served token is not written yet)."""
    live = [(len(r.tokens) + len(r.output) - 1, i)
            for i, r in enumerate(batcher.slots) if r is not None]
    if not live:
        return []
    live.sort(reverse=True)
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x9a6])
    pick = [live[0]] + [live[int(j) + 1] for j in
                        rng.permutation(len(live) - 1)[:n - 1]]
    pools = batcher._cache["slots"][0]
    out = []
    for rows, i in pick:
        r, pages = batcher.slots[i], batcher.ledger.slot_pages[i]
        toks = torch.as_tensor(np.concatenate(
            [np.asarray(r.tokens), np.asarray(r.output[:-1])]))
        out.append((toks, _rows(pools["kp"][0], pages, rows),
                    _rows(pools["vp"][0], pages, rows)))
    return out


def _traced_cycles(batcher, spans, feed, step, wl, device, record) -> list:
    """The traced window: `profile_cycles` admission-and-chunk cycles
    under torch.profiler recording device activity alone (so the host
    runs at its untraced pace): busy time, kernel times and the calls'
    shapes. Then one more cycle recording host operations too, for the
    breakdown of idle gaps. Fills the record's trace; returns the requests
    the cycles finished."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == "cuda"
    finished: list = []

    def cycle():
        nonlocal finished
        feed()
        finished += step()

    _sync(device)
    spans.tracing = True
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t = time.perf_counter()
        for _ in range(int(wl["profile_cycles"])):
            cycle()
        _sync(device)
        window_s = time.perf_counter() - t
    spans.tracing = False
    t = time.perf_counter()
    busy, kernels = devtrace.device_time(devtrace.profile_events(prof))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            cycle()
            _sync(device)
    record["trace"] = {
        "busy_s": busy, "window_s": window_s, "kernels": kernels,
        "prefill_S": list(spans.traced_prefill),
        "decode_rows": spans.traced_rows(),
        "breakdown": devtrace.breakdown(devtrace.profile_events(prof))}
    log(f"traced window {window_s:.3f} s, device busy {busy:.3f} s; "
        f"traces read in {time.perf_counter() - t:.3f} s")
    return finished
