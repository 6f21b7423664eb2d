"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) and
DeepSeek-V2-Lite's model (MLA + fine-grained MoE with shared experts and a
leading dense layer) against the reference's on the CPU, the reference's
parameters carried across with ``kv_norm`` and every norm perturbed:
``mla_apply``, the absorbed ``mla_decode`` with its latent cache, and the
whole model's forward, logits_last and decode.  Tolerances and routing
rules are in ``torch_lm_parity``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as JMLA
from repro.models import schema as JS
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import schema as S
from torch_lm_parity import DTYPES, F32_BOUND, KEY, carry, cfgs, close, model_parity, perturb, randn


def _mla_params(jcfg):
    return perturb(JS.init_params(JMLA.mla_schema(jcfg), KEY), seed=1)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_apply_matches_reference(dtype):
    """Full-sequence MLA: K and V expanded per head, causal, 12 positions."""
    jcfg, tcfg = cfgs("deepseek_v2_lite_16b", dtype)
    params = _mla_params(jcfg)
    x = randn(2, 12, jcfg.d_model, seed=1)
    pos = np.arange(12, dtype=np.int32)
    ref = JMLA.mla_apply(params, jnp.asarray(x, jcfg.compute_dtype), jcfg, jnp.asarray(pos))
    got = MLA.mla_apply(carry(params), torch.from_numpy(x).to(tcfg.compute_dtype), tcfg,
                        torch.from_numpy(pos))
    assert got.dtype == tcfg.compute_dtype
    close(got, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_latent_matches_reference(dtype):
    """The normalized latent (``kv_norm`` read in fp32) and the rope'd
    shared key, at positions up to 4,095."""
    jcfg, tcfg = cfgs("deepseek_v2_lite_16b", dtype)
    params = _mla_params(jcfg)
    x = randn(2, 6, jcfg.d_model, seed=2)
    pos = np.array([0, 1, 7, 100, 1000, 4095], np.int32)
    rc, rk = JMLA._latent(params, jnp.asarray(x, jcfg.compute_dtype), jcfg, jnp.asarray(pos))
    gc, gk = MLA._latent(carry(params), torch.from_numpy(x).to(tcfg.compute_dtype), tcfg,
                         torch.from_numpy(pos))
    close(gc, rc, dtype)
    close(gk, rk, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_decode_matches_reference(dtype):
    """10 absorbed decode steps into an 8-row latent cache: the output and
    the whole cache after every step; positions 8 and 9 write the last row,
    as ``dynamic_update_slice`` clamps its start."""
    jcfg, tcfg = cfgs("deepseek_v2_lite_16b", dtype)
    params = _mla_params(jcfg)
    tp = carry(params)
    width = jcfg.mla.kv_lora_rank + jcfg.mla.qk_rope_head_dim
    jcache = jnp.zeros((2, 8, width), jcfg.compute_dtype)
    tcache = torch.zeros((2, 8, width), dtype=tcfg.compute_dtype)
    step = jax.jit(lambda p, x, c, pos: JMLA.mla_decode(p, x, c, pos, jcfg))
    for i in range(10):
        x = randn(2, 1, jcfg.d_model, seed=10 + i)
        ry, jcache = step(params, jnp.asarray(x, jcfg.compute_dtype), jcache,
                          jnp.asarray(i, jnp.int32))
        gy, out = MLA.mla_decode(tp, torch.from_numpy(x).to(tcfg.compute_dtype), tcache, i, tcfg)
        assert out is tcache  # written in place
        close(gy, ry, dtype)
        close(tcache, jcache, dtype)


def test_mla_decode_matches_mla_apply():
    """The absorbed decode reproduces the expanded full-sequence attention
    position by position (fp32)."""
    _, cfg = cfgs("deepseek_v2_lite_16b", "f32")
    params = S.init_params(MLA.mla_schema(cfg), torch.Generator().manual_seed(3), "cpu")
    x = torch.from_numpy(randn(2, 8, cfg.d_model, seed=4))
    full = MLA.mla_apply(params, x, cfg, torch.arange(8, dtype=torch.int32))
    cache = torch.zeros((2, 8, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim))
    for i in range(8):
        y, _ = MLA.mla_decode(params, x[:, i:i + 1], cache, i, cfg)
        assert float((y[:, 0] - full[:, i]).abs().max()) < F32_BOUND, i


# ---------------------------------------------------------------------------
# the model (deepseek: one dense MLA layer, then MLA + MoE layers)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("capacity_factor", [None, 16.0])
def test_deepseek_model_matches_reference(capacity_factor, dtype, monkeypatch):
    """forward, logits_last and 8 decode steps (the latent and dense_latent
    caches), at the published capacity factor and at 16."""
    moe = {"capacity_factor": capacity_factor} if capacity_factor else None
    model_parity("deepseek_v2_lite_16b", dtype, monkeypatch, b=2, s=16, moe=moe)


def test_deepseek_decode_matches_forward():
    """The port's own decode reproduces its teacher-forced forward (fp32,
    capacity factor 16, as the reference's decode test)."""
    cfg = smoke_config(get_config("deepseek_v2_lite_16b"))
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = S.init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    hid, _ = M.forward(params, {"tokens": toks}, cfg)
    ref = L.unembed_logits(M._unembed_table(params, cfg), hid, cfg)
    cache = D.init_cache(cfg, 2, 8, "cpu")
    assert set(cache) == {"latent", "dense_latent"}
    for i in range(8):
        logits, cache = D.decode_step(params, cache, {"tokens": toks[:, i:i + 1], "pos": i}, cfg)
        assert float((logits - ref[:, i]).abs().max()) < F32_BOUND, i
