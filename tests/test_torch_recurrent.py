"""Parity of the port's recurrent blocks with the JAX reference on the CPU,
with the reference's weights (`DecoderLM.init` → `from_jax_params`) and
numpy inputs:

* RG-LRU (`repro_torch.models.rglru`): the log-depth scan against
  `jax.lax.associative_scan` (with and without a carried state), the
  causal conv, the full-sequence block, the prefill's final state and conv
  buffer (`transformer._rglru_prefill`), and decode steps;
* SSD (`repro_torch.models.ssm`): `ssd_chunked` (several chunk sizes, with
  an initial state), `ssd_step`, the conv step, the full-sequence block,
  the prefill's final state and conv buffers (`transformer._ssm_prefill`)
  and decode steps.

Outputs agree within 1e-5 absolute, scan states within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import build_model
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models.transformer import _rglru_prefill, _ssm_prefill
import repro_torch.configs as tconfigs
from repro_torch.models import rglru, ssm
from repro_torch.params import from_jax_params

ATOL = 1e-5
RTOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _scan_close(got, want):
    """A scan state within RTOL of the reference's, relative to the
    largest magnitude of the reference's state."""
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= RTOL * max(1.0, np.abs(want).max()), err


def _block(name, key, seed=0):
    cfg = reduced(get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    jm = build_model(cfg, compute_dtype=jnp.float32, remat="none")
    jparams = jm.init(jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.device_get(jparams), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0][key])
    tp = {k: v[0] for k, v in tparams["blocks"][0][key].items()}
    return cfg, tcfg, jp, tp


# the reference's functions, compiled once per shape (cfg is static)
J_RGLRU = jax.jit(jrg.apply_rglru, static_argnums=0)
J_RGLRU_PREFILL = jax.jit(_rglru_prefill, static_argnums=0)
J_RGLRU_DECODE = jax.jit(jrg.apply_rglru_decode, static_argnums=0)
J_SSM = jax.jit(jssm.apply_ssm, static_argnums=0)
J_SSM_PREFILL = jax.jit(_ssm_prefill, static_argnums=0)
J_SSM_DECODE = jax.jit(jssm.apply_ssm_decode, static_argnums=0)
J_SSD = jax.jit(jssm.ssd_chunked, static_argnums=5)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("S", [1, 5, 24, 64])
def test_rglru_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a_log = -rng.uniform(0.01, 1.0, size=(2, S, 8)).astype(np.float32)
    x = rng.standard_normal((2, S, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    for init in (None, h0):
        jh, jlast = jrg.rglru_scan(jnp.asarray(x), jnp.asarray(a_log),
                                   None if init is None else jnp.asarray(init))
        th, tlast = rglru.rglru_scan(
            torch.from_numpy(x), torch.from_numpy(a_log),
            None if init is None else torch.from_numpy(init))
        _scan_close(th, jh)
        _scan_close(tlast, jlast)


def test_rglru_block_prefill_and_decode_match_jax():
    cfg, tcfg, jp, tp = _block("recurrentgemma-2b", "rec")
    x = _x((2, 48, cfg.d_model), 1)
    w = jp["conv"]
    _close(rglru._conv_causal(torch.from_numpy(x[..., :w.shape[1]]),
                              torch.from_numpy(np.array(w))),
           jrg._conv_causal(jnp.asarray(x[..., :w.shape[1]]), w))
    _close(rglru.apply_rglru(tcfg, tp, torch.from_numpy(x)),
           J_RGLRU(cfg, jp, jnp.asarray(x)))
    jout, jfin = J_RGLRU_PREFILL(cfg, jp, jnp.asarray(x))
    tout, tfin = rglru.rglru_prefill(tcfg, tp, torch.from_numpy(x))
    _close(tout, jout)
    _scan_close(tfin["h"], jfin["h"])
    _close(tfin["conv"], jfin["conv"])
    # three decode steps from the prefilled state
    jc = {"h": jfin["h"], "conv": jfin["conv"]}
    tc = {"h": tfin["h"], "conv": tfin["conv"]}
    for t in range(3):
        xt = _x((2, 1, cfg.d_model), 10 + t)
        jy, jc = J_RGLRU_DECODE(cfg, jp, jnp.asarray(xt), jc)
        ty, tc = rglru.apply_rglru_decode(tcfg, tp, torch.from_numpy(xt), tc)
        _close(ty, jy)
        _scan_close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])
    empty = rglru.init_rglru_cache(tcfg, 3, device="cpu")
    for k, v in jrg.init_rglru_cache(cfg, 3).items():
        assert tuple(empty[k].shape) == v.shape
        assert empty[k].dtype == getattr(torch, str(v.dtype))


@pytest.mark.parametrize("S,chunk", [(32, 8), (32, 32), (24, 64), (64, 16)])
def test_ssd_chunked_matches_jax(S, chunk):
    rng = np.random.default_rng(S + chunk)
    b, H, P, N = 2, 3, 8, 4
    arrs = dict(x=rng.normal(size=(b, S, H, P)),
                dt=rng.uniform(0.1, 0.9, size=(b, S, H)),
                A=-rng.uniform(0.5, 1.5, size=(H,)),
                B=rng.normal(size=(b, S, N)), C=rng.normal(size=(b, S, N)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    s0 = rng.normal(size=(b, H, P, N)).astype(np.float32)
    for init in (None, s0):
        jy, js = J_SSD(
            *(jnp.asarray(arrs[k]) for k in "x dt A B C".split()), chunk,
            None if init is None else jnp.asarray(init))
        ty, ts = ssm.ssd_chunked(
            *(torch.from_numpy(arrs[k]) for k in "x dt A B C".split()),
            chunk, None if init is None else torch.from_numpy(init))
        _close(ty, jy)
        _scan_close(ts, js)
    # one recurrence step
    st = rng.normal(size=(b, H, P, N)).astype(np.float32)
    jy, js = jssm.ssd_step(jnp.asarray(st), *(jnp.asarray(arrs[k][:, 0])
                                              for k in ("x", "dt")),
                           jnp.asarray(arrs["A"]),
                           *(jnp.asarray(arrs[k][:, 0]) for k in "BC"))
    ty, ts = ssm.ssd_step(torch.from_numpy(st),
                          *(torch.from_numpy(arrs[k][:, 0])
                            for k in ("x", "dt")),
                          torch.from_numpy(arrs["A"]),
                          *(torch.from_numpy(arrs[k][:, 0]) for k in "BC"))
    _close(ty, jy)
    _scan_close(ts, js)


def test_ssm_block_prefill_and_decode_match_jax():
    cfg, tcfg, jp, tp = _block("mamba2-130m", "ssm")
    x = _x((2, 64, cfg.d_model), 2)            # two chunks of 32
    c = jp["conv_B"]
    xs = x[..., :c.shape[1]]
    _close(ssm._causal_conv(torch.from_numpy(xs),
                            torch.from_numpy(np.array(c))),
           jssm._causal_conv(jnp.asarray(xs), c))
    buf = _x((2, 3, c.shape[1]), 3)
    jo, jb = jssm._conv_step(jnp.asarray(xs[:, 0]), jnp.asarray(buf), c)
    to, tb = ssm._conv_step(torch.from_numpy(xs[:, 0]),
                            torch.from_numpy(buf),
                            torch.from_numpy(np.array(c)))
    _close(to, jo)
    _close(tb, jb)
    _close(ssm.apply_ssm(tcfg, tp, torch.from_numpy(x)),
           J_SSM(cfg, jp, jnp.asarray(x)))
    jout, jfin = J_SSM_PREFILL(cfg, jp, jnp.asarray(x))
    tout, tfin = ssm.ssm_prefill(tcfg, tp, torch.from_numpy(x))
    _close(tout, jout)
    _scan_close(tfin["state"], jfin["state"])
    for k in ("conv_x", "conv_B", "conv_C"):
        _close(tfin[k], jfin[k])
    jc, tc = dict(jfin), dict(tfin)
    for t in range(3):
        xt = _x((2, 1, cfg.d_model), 20 + t)
        jy, jc = J_SSM_DECODE(cfg, jp, jnp.asarray(xt), jc)
        ty, tc = ssm.apply_ssm_decode(tcfg, tp, torch.from_numpy(xt), tc)
        _close(ty, jy)
        _scan_close(tc["state"], jc["state"])
        for k in ("conv_x", "conv_B", "conv_C"):
            _close(tc[k], jc[k])
    empty = ssm.init_ssm_cache(tcfg, 3, device="cpu")
    for k, v in jssm.init_ssm_cache(cfg, 3).items():
        assert tuple(empty[k].shape) == v.shape
        assert empty[k].dtype == getattr(torch, str(v.dtype))
