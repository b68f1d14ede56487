"""Parity of the port's quantized paged KV cache with the JAX reference on
the CPU, on reduced dsr1d-qwen-1.5b and gpt2-xl (2 layers), for int8 pages
(per-row float32 scales) and fp8 E4M3 code pages: prefill into pages plus
three paged decode steps. Logits agree within 1e-4 (as
`test_torch_models.py`: float32 products in another order). The port's and
XLA's float32 K/V rows may differ in the last ulp, and a row on a rounding
edge then takes the neighbouring code, so pools are held to at most one
code step and scales to rel 1e-6. The batcher on these pools:
`test_torch_quant_serve.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.models.transformer import init_paged_cache as jax_init_paged
from repro.models.transformer import \
    write_prefill_to_pages as jax_write_pages
import repro_torch.configs as tconfigs
from repro_torch.models import (DecoderLM, init_paged_cache,
                                write_prefill_to_pages)
from repro_torch.params import from_jax_params

ARCHS = ["dsr1d-qwen-1.5b", "gpt2-xl"]
KV = ["int8", "fp8"]
ATOL = 1e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = reduced(get_arch(request.param), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param), layers=2)
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    tm = DecoderLM(tcfg, compute_dtype=torch.float32, device="cpu")
    return cfg, tcfg, jm, jparams, tm, tparams


def _code_steps(got: np.ndarray, want: np.ndarray, kv: str) -> int:
    """Largest distance between two pools in code steps: int8 codes
    directly; fp8 E4M3 codes by their order on the number line (sign
    folded, so -0 and +0 are the same step)."""
    if kv == "int8":
        return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())

    def rank(c):
        c = c.astype(np.int32)
        return np.where(c & 0x80, -(c & 0x7F), c)
    return int(np.abs(rank(got) - rank(want)).max())


@pytest.mark.parametrize("kv", KV)
def test_prefill_and_quantized_paged_decode_match_jax(pair, kv):
    cfg, tcfg, jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(5)
    ps, P, N = 8, 6, 24
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (19, 10)]
    jcache = jax_init_paged(cfg, 3, N, ps, P, dtype=jnp.float32, kv_dtype=kv)
    tcache = init_paged_cache(tcfg, 3, N, ps, P, dtype=torch.float32,
                              device="cpu", kv_dtype=kv)
    assert sorted(tcache["slots"][0]) == sorted(jcache["slots"][0])
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step_paged, static_argnames="attn_backend")
    next_tok = np.zeros((3, 1), np.int64)
    first_page = 1
    for slot, prompt in zip((1, 2), prompts):     # slot 0 stays inactive
        npg = -(-len(prompt) // ps)
        pages = np.arange(first_page, first_page + npg, dtype=np.int32)
        first_page += npg + 1
        jl, jd = jprefill(jparams, {"tokens": jnp.asarray(prompt[None])},
                          npg * ps)
        tl, td = tm.prefill(tparams, {"tokens": torch.from_numpy(
            prompt[None])}, npg * ps)
        jcache = jax_write_pages(cfg, jcache, jd, slot, jnp.asarray(pages))
        write_prefill_to_pages(tcfg, tcache, td, slot,
                               torch.from_numpy(pages))
        jcache["page_table"] = jcache["page_table"].at[slot, npg].set(
            first_page - 1)
        tcache["page_table"][slot, npg] = first_page - 1
        next_tok[slot, 0] = int(np.argmax(np.asarray(jl)[0, -1]))
    for _ in range(3):
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(next_tok, jnp.int32),
                             attn_backend="ref")
        tl, tcache = tm.decode_step_paged(tparams, tcache,
                                          torch.from_numpy(next_tok))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy()[1:], jl[1:], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[1:],
                                      jl.argmax(-1)[1:])
        next_tok = jl.argmax(-1).astype(np.int64)
    entry, jentry = tcache["slots"][0], jcache["slots"][0]
    for name in ("kp", "vp"):
        got, want = entry[name].numpy(), np.asarray(jentry[name])
        assert got.dtype == want.dtype
        # page 0 is the null page the inactive slot writes garbage into
        assert _code_steps(got[:, 1:], want[:, 1:], kv) <= 1
    for name in ("ks", "vs") if kv == "int8" else ():
        got, want = entry[name].numpy()[:, 1:], np.asarray(jentry[name])[:, 1:]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert (got > 0).any()
