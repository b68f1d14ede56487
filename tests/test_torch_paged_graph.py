"""The paged decode step through the buffers its CUDA graph owns
(`models/paged_graph.py`), against the eager step.

On the CPU `DecoderLM.decode_step_static` runs the body the graph captures
(`paged_decode_step`) eagerly on the `StepGraph`'s own buffers, so these
tests hold what a replay relies on: the caller's tokens, positions, table
and mask copied in at every call (the batcher rebinds the table and the
mask, and an admission writes a position in place between chunks), the
logits and positions handed back as copies, and one `StepGraph` a batcher.
A serve of two chunks with a retirement and an admission between them
must give the eager serve's tokens, logits and pools bit for bit, on bf16,
fp8 and int8 pages and on a recurrent (SSD) stack.

The `gpu` cases replay the captured graph on the card against the eager
body there: tokens, logits and pages bit for bit, one capture across
chunks, logits held across calls, and a speculative serve."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import build
from repro_torch.models import (DecoderLM, init_paged_cache,
                                self_spec_draft, write_prefill_to_pages)
from repro_torch.models.paged_graph import WARMUP_STEPS, StepCounts
from repro_torch.models.transformer import paged_decode_step
from repro_torch.params import init_params
from repro_torch.serve import PagedContinuousBatcher, Request

# (config, kv_dtype): three pool formats on a GQA stack, and an SSD stack
CASES = [("dsr1d-qwen-1.5b", "bf16"), ("dsr1d-qwen-1.5b", "fp8"),
         ("dsr1d-qwen-1.5b", "int8"), ("mamba2-130m", "native")]
PAGED = dict(num_slots=2, page_size=8, num_pages=32, max_pages_per_slot=8,
             chunk_steps=4, collect_logits=True)


@functools.lru_cache(maxsize=None)
def setup(name, device="cpu", dtype=torch.float32):
    cfg = reduced(get_arch(name), layers=2)
    gen = torch.Generator(device=device).manual_seed(7)
    return cfg, init_params(cfg, gen, device=device, dtype=dtype)


def eager(model: DecoderLM) -> DecoderLM:
    """`model` with its paged step bound to the eager body: the path the
    graph replaces, on any device."""
    def step(params, cache, tokens):
        model.step_counts.eager += 1
        logits, cache["pos"] = paged_decode_step(
            model.cfg, model.compute_dtype, params, cache, tokens)
        return logits, cache
    model.decode_step_paged = step
    return model


def static(model: DecoderLM) -> DecoderLM:
    """`model` with its paged step bound to the graph's buffers (a replay
    on the card, the body on those buffers elsewhere)."""
    model.decode_step_paged = model.decode_step_static
    return model


def stream(vocab):
    """Three requests for two slots: the first retires in the first chunk
    and the third is admitted into its slot before the second."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, 13), 3), (rng.integers(0, vocab, 9), 7),
            (rng.integers(0, vocab, 20), 5)]


def serve(model, params, kv_dtype, **kw):
    b = PagedContinuousBatcher(model, params, kv_dtype=kv_dtype,
                               **{**PAGED, **kw})
    for i, (p, n) in enumerate(stream(model.cfg.vocab_size)):
        b.submit(Request(rid=i, tokens=p, max_new_tokens=n))
    done = sorted(b.run(), key=lambda r: r.rid)
    return b, done


def tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    return [t for v in tree for t in tensors(v)]


def assert_same_serve(a, b):
    (ba, da), (bb, db) = a, b
    assert [r.output for r in da] == [r.output for r in db]
    for ra, rb in zip(da, db):
        assert len(ra.logits) == len(rb.logits)
        for x, y in zip(ra.logits, rb.logits):
            assert np.array_equal(x, y, equal_nan=True)
    for key in ("slots", "tail", "pos", "page_table", "active"):
        for x, y in zip(tensors(ba._cache[key]), tensors(bb._cache[key])):
            assert torch.equal(x, y), key
    assert ba.stats == bb.stats


@pytest.mark.parametrize("name,kv", CASES)
def test_static_buffers_serve_as_eager(name, kv):
    """Two chunks, a retirement and an admission between them: the static
    buffers' serve equals the eager serve's tokens, logits, pools and
    state; one `StepGraph` serves every step of the batcher."""
    cfg, params = setup(name)
    want = serve(eager(DecoderLM(cfg, torch.float32, "cpu")), params, kv)
    model = static(DecoderLM(cfg, torch.float32, "cpu"))
    graphs = []
    step = model.decode_step_static

    def spy(params, cache, tokens):
        out = step(params, cache, tokens)
        graphs.append(model._step_graph)
        return out
    model.decode_step_paged = spy
    got = serve(model, params, kv)
    assert got[0].stats.chunks >= 2 and got[0].stats.admitted == 3
    assert_same_serve(got, want)
    assert len(set(map(id, graphs))) == 1
    assert model.step_counts == StepCounts(eager=len(graphs))


def _one_slot_cache(cfg, params, model, kv):
    cache = init_paged_cache(cfg, 2, 8, 8, 3, dtype=torch.float32,
                             device="cpu", kv_dtype=kv)
    _, dense = model.prefill(params, {"tokens": torch.arange(11)[None]}, 16)
    write_prefill_to_pages(cfg, cache, dense, 0, torch.tensor([1, 2]))
    return cache


@pytest.mark.parametrize("name,kv", CASES)
def test_outputs_are_the_callers(name, kv):
    """Logits and positions a call hands back, and positions the caller
    held before it, are unchanged by later calls; a position written in
    place between calls is read by the next."""
    cfg, params = setup(name)
    model = DecoderLM(cfg, torch.float32, "cpu")
    cache = _one_slot_cache(cfg, params, model, kv)
    tok = torch.tensor([[3], [0]])
    held = cache["pos"]
    first, cache = model.decode_step_static(params, cache, tok)
    kept, pos1 = first.clone(), cache["pos"]
    assert pos1 is not held and held.tolist() == [11, 0]
    second, cache = model.decode_step_static(params, cache, tok + 1)
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert pos1.tolist() == [12, 0] and cache["pos"].tolist() == [13, 0]
    cache["pos"][0] = 5                 # an admission's in-place write
    cache["active"] = torch.tensor([True, True])       # a rebinding
    _, cache = model.decode_step_static(params, cache, tok)
    assert cache["pos"].tolist() == [6, 1]


@pytest.mark.parametrize("change", ["pool", "table", "slots", "tokens",
                                    "params"])
def test_new_layout_new_graph(change):
    """A step keeps its `StepGraph` while only the inputs' values and
    bindings change, and gets a new one when something the graph captured
    changes: the pools' storage, the table's width, the slot count, the
    tokens' dtype or the parameters."""
    cfg, params = setup("dsr1d-qwen-1.5b")
    model = DecoderLM(cfg, torch.float32, "cpu")
    cache = init_paged_cache(cfg, 2, 8, 8, 3, dtype=torch.float32,
                             device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    model.decode_step_static(params, cache, tok)
    g = model._step_graph
    cache["page_table"] = cache["page_table"].clone()
    cache["active"] = torch.ones(2, dtype=torch.bool)
    model.decode_step_static(params, cache, tok + 1)
    assert model._step_graph is g
    if change == "pool":
        cache = {**cache, "slots": [{k: v.clone() for k, v in e.items()}
                                    for e in cache["slots"]]}
    elif change == "table":
        cache = {**cache, "page_table": torch.zeros((2, 4),
                                                    dtype=torch.int32)}
    elif change == "slots":
        cache = {**cache, "pos": torch.zeros(3, dtype=torch.int32),
                 "page_table": torch.zeros((3, 3), dtype=torch.int32),
                 "active": torch.ones(3, dtype=torch.bool)}
        tok = torch.zeros((3, 1), dtype=torch.long)
    elif change == "tokens":
        tok = tok.int()
    else:
        params = {**params, "final_norm": {
            k: v.clone() for k, v in params["final_norm"].items()}}
    model.decode_step_static(params, cache, tok)
    assert model._step_graph is not g
    assert model.step_counts.eager == 3


@pytest.mark.parametrize("times", [1, -1, 3])
def test_replay_launch_accounting(times):
    """A replay adds its capture's launches to the kernels' counts; -1
    takes back those the capture's own calls counted."""
    kernels = ("paged_gqa_decode", "flash_attention")
    before = build.launch_counts()
    build.add_launches({"paged_gqa_decode": 28, "flash_attention": 2}, times)
    after = build.launch_counts()
    build.add_launches({"paged_gqa_decode": 28, "flash_attention": 2},
                       -times)
    assert [after[k] - before[k] for k in kernels] == [28 * times, 2 * times]
    assert build.launch_counts() == before


# ---------------------------------------------------------------- the card

GPU_CASES = [("dsr1d-qwen-1.5b", "native"), ("gpt2-xl", "native"),
             ("dsr1d-qwen-1.5b", "fp8"), ("dsr1d-qwen-1.5b", "int8")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name,kv", GPU_CASES)
def test_graph_replay_equals_eager_on_card(name, kv):
    """16-step chunks, a retirement and an admission, a second chunk: the
    replayed graph gives the eager body's greedy tokens, logits and pages
    bit for bit, from one capture, with every step after the warm-up
    replayed and the kernels' launch counts those of the eager serve."""
    _card()
    cfg, params = setup(name, "cuda", torch.bfloat16)
    kw = dict(chunk_steps=16)
    build.reset_launch_counts()
    want = serve(eager(DecoderLM(cfg, torch.bfloat16, "cuda")), params, kv,
                 **kw)
    want_launches = build.launch_counts()
    model = DecoderLM(cfg, torch.bfloat16, "cuda")
    build.reset_launch_counts()
    got = serve(model, params, kv, **kw)
    assert got[0].stats.chunks >= 2 and got[0].stats.admitted == 3
    assert_same_serve(got, want)
    steps = got[0].stats.chunks * 16
    assert model.step_counts == StepCounts(
        captures=1, replays=steps - WARMUP_STEPS, eager=WARMUP_STEPS)
    assert build.launch_counts() == want_launches


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dsr1d-qwen-1.5b", "gpt2-xl"])
def test_replayed_logits_stay_the_callers_on_card(name):
    """Logits from call n are unchanged by call n + 1's replay."""
    _card()
    cfg, params = setup(name, "cuda", torch.bfloat16)
    model = DecoderLM(cfg, torch.bfloat16, "cuda")
    cache = init_paged_cache(cfg, 2, 8, 8, 3, device="cuda")
    _, dense = model.prefill(params, {"tokens": torch.arange(
        11, device="cuda")[None]}, 16)
    write_prefill_to_pages(cfg, cache, dense, 0, torch.tensor([1, 2]))
    outs = []
    for i in range(WARMUP_STEPS + 3):
        tok = torch.full((2, 1), 5 + i, device="cuda")
        logits, cache = model.decode_step_paged(params, cache, tok)
        outs.append((logits, logits.clone()))
    assert model.step_counts.captures == 1
    for held, copy in outs:
        assert torch.equal(held, copy)
    assert not torch.equal(outs[-1][0], outs[-2][0])
    assert cache["pos"].tolist() == [11 + WARMUP_STEPS + 3, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dsr1d-qwen-1.5b", "gpt2-xl"])
def test_speculative_serve_with_graphed_draft_on_card(name):
    """A speculative serve whose draft steps replay the draft's own graph
    emits the tokens of the same serve with an eager draft."""
    _card()
    cfg, params = setup(name, "cuda", torch.bfloat16)
    runs = []
    for graphed in (False, True):
        model = DecoderLM(cfg, torch.bfloat16, "cuda")
        draft, dparams = self_spec_draft(model, params, skip=2)
        if not graphed:
            eager(draft)
        kw = {**PAGED, "collect_logits": False, "num_pages": 64}
        b = PagedContinuousBatcher(model, params, speculate_k=3,
                                   draft_model=draft, draft_params=dparams,
                                   **kw)
        for i, (p, n) in enumerate(stream(cfg.vocab_size)):
            b.submit(Request(rid=i, tokens=p, max_new_tokens=n))
        runs.append(([r.output for r in sorted(b.run(),
                                                key=lambda r: r.rid)],
                     draft.step_counts))
    assert runs[0][0] == runs[1][0]
    assert runs[1][1].captures == 1 and runs[1][1].replays > 0
