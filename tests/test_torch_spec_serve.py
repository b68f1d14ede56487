"""Parity of the port's speculative paged batcher with the JAX reference on
the CPU: `PagedContinuousBatcher(speculate_k=...)` in both packages, with a
4-layer reduced dsr1d target and its 2-layer skip-2 self-spec draft, which
rejects candidates. Tokens, `PagedStats`, occupancy-trace events and access
bytes must be equal, for k = 1, 2, 3 on native pages and k = 2 on fp8
pages, and the port's speculative tokens equal its non-speculative ones.
(Kept apart from `test_torch_spec.py` so each file runs in under a minute
on one core.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.serve import PagedContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
import repro_torch.configs as tconfigs
from repro_torch.models import DecoderLM
from repro_torch.params import from_jax_params
from repro_torch.serve import PagedContinuousBatcher, PagedStats, Request

ARCH = "dsr1d-qwen-1.5b"
GEOMETRY = dict(num_slots=2, page_size=8, num_pages=64, max_pages_per_slot=8,
                chunk_steps=4)


@pytest.fixture(scope="module")
def small4():
    cfg = reduced(get_arch(ARCH), layers=4)
    tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH), layers=4)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (7, 12, 5)]
    return jm, jparams, tm, tparams, prompts, [11, 9, 13]


def _serve(batcher, request_cls, prompts, new):
    for i, (p, n) in enumerate(zip(prompts, new)):
        batcher.submit(request_cls(rid=i, tokens=p, max_new_tokens=n))
    return [r.output for r in sorted(batcher.run(), key=lambda r: r.rid)]


def _assert_same_run(jb, tb, jout, tout):
    assert tout == jout
    fields = PagedStats.__dataclass_fields__
    assert {f: getattr(tb.stats, f) for f in fields} == \
        {f: getattr(jb.stats, f) for f in fields}
    jt, tt = jb.ledger.trace, tb.ledger.trace
    assert tt.ev_times == jt.ev_times
    assert tt.ev_dneeded == jt.ev_dneeded
    assert tt.ev_dobsolete == jt.ev_dobsolete
    assert tb.access.reads_bytes == jb.access.reads_bytes
    assert tb.access.writes_bytes == jb.access.writes_bytes
    assert tb.occupancy_bundle().total_time == jb.occupancy_bundle().total_time
    assert tb.ledger.allocator.n_allocated == 0


@pytest.mark.parametrize("k", [1, 2, 3])
def test_spec_batcher_matches_jax(small4, k):
    jm, jparams, tm, tparams, prompts, new = small4
    jb = JaxBatcher(jm, jparams, attn_backend="ref", speculate_k=k,
                    **GEOMETRY)
    tb = PagedContinuousBatcher(tm, tparams, speculate_k=k, **GEOMETRY)
    jout = _serve(jb, JaxRequest, prompts, new)
    tout = _serve(tb, Request, prompts, new)
    _assert_same_run(jb, tb, jout, tout)
    st = tb.stats
    assert st.accepted_tokens == sum(n - 1 for n in new)
    assert st.drafted_tokens == st.spec_rounds * k
    assert st.spec_rounds < st.accepted_tokens  # some round accepted > 1
    assert st.rolled_back_pages > 0             # and some rejected
    plain = PagedContinuousBatcher(tm, tparams, **GEOMETRY)
    assert _serve(plain, Request, prompts, new) == tout


def test_spec_batcher_on_fp8_pages_matches_jax(small4):
    jm, jparams, tm, tparams, prompts, new = small4
    kw = dict(speculate_k=2, kv_dtype="fp8", **GEOMETRY)
    jb = JaxBatcher(jm, jparams, attn_backend="ref", **kw)
    tb = PagedContinuousBatcher(tm, tparams, **kw)
    jout = _serve(jb, JaxRequest, prompts, new)
    tout = _serve(tb, Request, prompts, new)
    _assert_same_run(jb, tb, jout, tout)
    assert tb.page_bytes == jb.page_bytes
    assert tb.draft_page_bytes == jb.draft_page_bytes


