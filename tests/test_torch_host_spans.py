"""Host spans of the port's serving path (`repro_torch.obs.host_spans`) on
the CPU, with a 2-layer reduced dsr1d-qwen-1.5b: with no profiler running
nothing is logged and no profiler range is entered; under torch.profiler
the paged batcher and the decoder log the documented spans, each inside
its parent and counted as the work it times, with the same ranges in the
profiler's own trace; tokens and `PagedStats` are the same either way.
Runs the plain admission path the benchmark's cells take, and prefix
sharing with chunked prefill (a documented operator path)."""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import repro_torch.obs.host_spans as hs
from repro_torch.configs import get_arch
from repro_torch.configs.base import reduced
from repro_torch.models import DecoderLM
from repro_torch.obs.telemetry import _NULL_SPAN
from repro_torch.params import init_params
from repro_torch.serve.paged import PagedContinuousBatcher
from repro_torch.serve.scheduler import Request

NAMES = {"paged.admit", "paged.decode_chunk", "paged.sync",
         "paged.page_write", "model.prefill", "model.decode_step",
         "model.attn", "model.ffn"}
MODES = {"plain": {},
         "prefix_chunked": {"prefix_cache": True,
                            "prefill_chunk_tokens": 16}}
CHUNK = 4


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_arch("dsr1d-qwen-1.5b"), layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    return DecoderLM(cfg, compute_dtype=torch.float32, device="cpu"), params


def serve(model, mode: str, profiled: bool):
    """Five requests (a shared 24-token head, tails of 5 to 30 tokens) on
    three slots; returns the batcher, tokens by rid, the host spans logged
    and the profiler's events (none unprofiled)."""
    m, params = model
    b = PagedContinuousBatcher(m, params, num_slots=3, page_size=8,
                               num_pages=64, chunk_steps=CHUNK, **MODES[mode])
    rng = np.random.default_rng(7)
    V = m.cfg.vocab_size
    head = rng.integers(0, V, 24)
    for rid, n in enumerate((5, 13, 30, 9, 21)):
        b.submit(Request(rid=rid, tokens=np.concatenate(
            [head, rng.integers(0, V, n)]), max_new_tokens=5 + 3 * rid))
    log = hs.host_registry()
    log.spans.clear()
    events = []
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            done = b.run()
        events = list(prof.profiler.kineto_results.events())
    else:
        done = b.run()
    spans = list(log.spans)
    log.spans.clear()
    return b, {r.rid: list(r.output) for r in done}, spans, events


def test_no_profiler_no_span_and_no_range(model, monkeypatch):
    entered = []
    enter = hs._range_enter
    monkeypatch.setattr(hs, "_range_enter",
                        lambda name: entered.append(name) or enter(name))
    assert hs.host_span("paged.admit") is _NULL_SPAN
    _, out, spans, _ = serve(model, "plain", profiled=False)
    assert spans == [] and entered == [] and len(out) == 5
    # the same counter sees every range while a profiler runs
    _, _, spans, _ = serve(model, "plain", profiled=True)
    assert len(entered) == len(spans) > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_and_stats_unchanged_by_profiling(model, mode):
    b0, out0, _, _ = serve(model, mode, profiled=False)
    b1, out1, _, _ = serve(model, mode, profiled=True)
    assert out1 == out0
    assert dataclasses.asdict(b1.stats) == dataclasses.asdict(b0.stats)
    assert b1.access == b0.access


def _within(child, parent) -> bool:
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spans_nest_as_the_layers_call(model, mode):
    _, _, spans, _ = serve(model, mode, profiled=True)
    assert {s.name for s in spans} == NAMES
    want_parent = {"paged.admit": {None},
                   "paged.decode_chunk": {None, "paged.admit"},
                   "paged.sync": {"paged.admit", "paged.decode_chunk"},
                   "paged.page_write": {"paged.admit"},
                   "model.prefill": {"paged.admit"},
                   "model.decode_step": {"paged.decode_chunk"},
                   "model.attn": {"model.prefill", "model.decode_step"},
                   "model.ffn": {"model.prefill", "model.decode_step"}}
    for s in spans:
        p = s.parent
        assert (p.name if p else None) in want_parent[s.name], s
        assert p is None or _within(s, p), s
    for s in spans:
        if s.name == "paged.sync":
            assert s.attrs["at"] in ("first_token", "chunk")
            assert s.parent.name == ("paged.admit" if s.attrs["at"]
                                     == "first_token"
                                     else "paged.decode_chunk")
    if mode == "plain":        # no chunk runs inside an admission
        assert all(s.parent is None for s in spans
                   if s.name == "paged.decode_chunk")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_span_counts_match_the_work(model, mode):
    b, _, spans, _ = serve(model, mode, profiled=True)
    n = Counter(s.name for s in spans)
    at = Counter(s.attrs["at"] for s in spans if s.name == "paged.sync")
    st = b.stats
    assert at == {"first_token": st.admitted, "chunk": st.chunks}
    assert n["paged.decode_chunk"] == st.chunks
    assert n["model.decode_step"] == CHUNK * st.chunks
    assert n["model.prefill"] == n["paged.page_write"]
    if mode == "plain":
        assert n["model.prefill"] == st.prefills == st.admitted == 5
        layers = b.cfg.num_layers
        assert n["model.attn"] == n["model.ffn"] == layers * (
            st.prefills + CHUNK * st.chunks)
    else:   # one prefill a slice, `prefill_shared` past the first
        assert st.prefix_hits > 0 and st.prefill_slices > 0
        assert n["model.prefill"] >= st.admitted + 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_profiler_trace_holds_the_same_ranges(model, mode):
    _, _, spans, events = serve(model, mode, profiled=True)
    ranges = Counter(e.name() for e in events if e.is_user_annotation()
                     and e.device_type() == DeviceType.CPU
                     and e.name() in NAMES)
    assert ranges == Counter(s.name for s in spans)


def test_log_is_capped_and_counts_what_it_drops(model, monkeypatch):
    dropped = hs.host_registry().counter("host_spans.dropped")
    before = dropped.value
    monkeypatch.setattr(hs, "SPAN_CAP", 10)
    log = hs.host_registry()
    log.spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(25):
            with hs.host_span("paged.admit"):
                pass
    assert len(log.spans) == 10 and dropped.value - before == 15
    log.spans.clear()
