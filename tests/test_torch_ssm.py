"""The port's Mamba2 block (``repro_torch.models.ssm``) and mamba2's model
against the reference's (``repro.models.ssm``) on the CPU, the reference's
parameters carried across with ``A_log``, ``D``, ``dt_bias``, the gated
``norm`` and the conv bias perturbed: ``ssd_chunked`` against the reference
and the per-timestep recurrence (``tests/test_ssd_oracle.py``'s oracle,
chunk-size invariance and initial-state continuation), ``ssm_apply``,
``ssm_decode`` with its state and conv caches, and the whole model.
Tolerances are in ``torch_lm_parity``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import schema as JS
from repro.models import ssm as JSSM
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import schema as S
from repro_torch.models import ssm as SSM
from torch_lm_parity import DTYPES, F32_BOUND, KEY, carry, cfgs, close, model_parity, perturb, randn


def ssd_naive(x, a, B, C, init=None):
    """O(S) recurrence in float64: h_t = exp(a_t) h_{t-1} + B_t x_t^T;
    y_t = C_t h_t."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh = np.repeat(np.asarray(B, np.float64), rep, axis=2)
    Ch = np.repeat(np.asarray(C, np.float64), rep, axis=2)
    state = np.zeros((b, h, p, B.shape[3])) if init is None else np.asarray(init, np.float64)
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        state = state * np.exp(a[:, t].astype(np.float64))[:, :, None, None] + np.einsum(
            "bhn,bhp->bhpn", Bh[:, t], x[:, t].astype(np.float64))
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Ch[:, t], state)
    return ys, state


def _rand(seed, b=2, s=32, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(b, s, h))) * 0.3).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, a, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    x, a, B, C = _rand(0)
    y, final = SSM.ssd_chunked(*_t(x, a, B, C), chunk)
    ry, rfinal = JSSM.ssd_chunked(*(jnp.asarray(v) for v in (x, a, B, C)), chunk)
    close(y, ry, "f32")
    close(final, rfinal, "f32")
    ny, nfinal = ssd_naive(x, a, B, C)
    np.testing.assert_allclose(y.numpy(), ny, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), nfinal, rtol=2e-4, atol=2e-4)
    assert final.dtype == torch.float32 and y.dtype == torch.float32


def test_ssd_chunk_size_invariance():
    x, a, B, C = _rand(1)
    y1, f1 = SSM.ssd_chunked(*_t(x, a, B, C), 4)
    y2, f2 = SSM.ssd_chunked(*_t(x, a, B, C), 32)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_initial_state_continuation():
    """Splitting a sequence in half with the state carried == the whole,
    and the carried half matches the reference's with the same
    ``init_state``."""
    x, a, B, C = _rand(2)
    y_full, f_full = SSM.ssd_chunked(*_t(x, a, B, C), 8)
    y1, f1 = SSM.ssd_chunked(*_t(x[:, :16], a[:, :16], B[:, :16], C[:, :16]), 8)
    y2, f2 = SSM.ssd_chunked(*_t(x[:, 16:], a[:, 16:], B[:, 16:], C[:, 16:]), 8, init_state=f1)
    np.testing.assert_allclose(y1.numpy(), y_full[:, :16].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y2.numpy(), y_full[:, 16:].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f2.numpy(), f_full.numpy(), rtol=2e-4, atol=2e-4)
    ry2, rf2 = JSSM.ssd_chunked(*(jnp.asarray(v[:, 16:]) for v in (x, a, B, C)), 8,
                                init_state=jnp.asarray(f1.numpy()))
    close(y2, ry2, "f32")
    close(f2, rf2, "f32")


def test_ssd_bf16_inputs_match_reference():
    """bf16 x, B, C: the products in fp32, y back in bf16, the state fp32."""
    x, a, B, C = _rand(3)
    y, f = SSM.ssd_chunked(*(v.bfloat16() for v in _t(x)), torch.from_numpy(a),
                           *(v.bfloat16() for v in _t(B, C)), 8)
    ry, rf = JSSM.ssd_chunked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
                              jnp.asarray(B, jnp.bfloat16), jnp.asarray(C, jnp.bfloat16), 8)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
    close(y, ry, "bf16")
    close(f, rf, "bf16")


def test_segsum_and_chunk_divisibility():
    a = torch.from_numpy(randn(3, 6, seed=4))
    np.testing.assert_allclose(SSM._segsum(a).numpy(), np.asarray(JSSM._segsum(jnp.asarray(
        a.numpy()))), rtol=1e-6, atol=1e-6)
    x, a, B, C = _rand(5, s=12)
    with pytest.raises(ValueError, match="chunk"):
        SSM.ssd_chunked(*_t(x, a, B, C), 8)


def _ssm_params(jcfg):
    return perturb(JS.init_params(JSSM.ssm_schema(jcfg), KEY), seed=2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["mamba2_13b", "zamba2_7b"])
def test_ssm_apply_matches_reference(arch, dtype):
    """The full-sequence block at 16 positions (two chunks of 8)."""
    jcfg, tcfg = cfgs(arch, dtype)
    params = _ssm_params(jcfg)
    x = randn(2, 16, jcfg.d_model, seed=6)
    ref = JSSM.ssm_apply(params, jnp.asarray(x, jcfg.compute_dtype), jcfg)
    got = SSM.ssm_apply(carry(params), torch.from_numpy(x).to(tcfg.compute_dtype), tcfg)
    assert got.dtype == tcfg.compute_dtype
    close(got, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_decode_matches_reference(dtype):
    """12 recurrent steps: the output, the fp32 SSM state and the conv
    window after every step, both written in place."""
    jcfg, tcfg = cfgs("mamba2_13b", dtype)
    params = _ssm_params(jcfg)
    tp = carry(params)
    (st, cv) = D._ssm_state_shapes(tcfg, 2)
    jst, jcv = jnp.zeros(st, jnp.float32), jnp.zeros(cv, jcfg.compute_dtype)
    tst, tcv = torch.zeros(st), torch.zeros(cv, dtype=tcfg.compute_dtype)
    step = jax.jit(lambda p, x, s, c: JSSM.ssm_decode(p, x, s, c, jcfg))
    for i in range(12):
        x = randn(2, 1, jcfg.d_model, seed=20 + i)
        ry, jst, jcv = step(params, jnp.asarray(x, jcfg.compute_dtype), jst, jcv)
        gy, s_out, c_out = SSM.ssm_decode(tp, torch.from_numpy(x).to(tcfg.compute_dtype),
                                          tst, tcv, tcfg)
        assert s_out is tst and c_out is tcv and tst.dtype == torch.float32
        close(gy, ry, dtype)
        close(tst, jst, dtype)
        close(tcv, jcv, dtype)


def test_ssm_decode_matches_apply():
    """The recurrence reproduces the chunked block position by position
    (fp32, the port's own parameters)."""
    _, cfg = cfgs("mamba2_13b", "f32")
    params = S.init_params(SSM.ssm_schema(cfg), torch.Generator().manual_seed(5), "cpu")
    params["A_log"] += 0.3
    params["dt_bias"] -= 0.5
    x = torch.from_numpy(randn(2, 16, cfg.d_model, seed=7))
    full = SSM.ssm_apply(params, x, cfg)
    st, cv = (torch.zeros(s) for s in D._ssm_state_shapes(cfg, 2))
    for i in range(16):
        y, _, _ = SSM.ssm_decode(params, x[:, i:i + 1], st, cv, cfg)
        assert float((y[:, 0] - full[:, i]).abs().max()) < F32_BOUND, i


# ---------------------------------------------------------------------------
# the model (mamba2: attention-free SSD blocks, tied embeddings)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba2_model_matches_reference(dtype, monkeypatch):
    """forward (two chunks), logits_last and 16 decode steps: the state and
    conv caches."""
    model_parity("mamba2_13b", dtype, monkeypatch, b=2, s=16, steps=16)


def test_mamba2_decode_matches_forward():
    """The port's own decode reproduces its teacher-forced forward over 16
    positions (two chunks; fp32)."""
    cfg = dataclasses.replace(smoke_config(get_config("mamba2_13b")), compute_dtype=torch.float32)
    params = S.init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    hid, _ = M.forward(params, {"tokens": toks}, cfg)
    ref = L.unembed_logits(M._unembed_table(params, cfg), hid, cfg)
    cache = D.init_cache(cfg, 2, 16, "cpu")
    assert set(cache) == {"state", "conv"} and cache["state"].dtype == torch.float32
    for i in range(16):
        logits, cache = D.decode_step(params, cache, {"tokens": toks[:, i:i + 1], "pos": i}, cfg)
        assert float((logits - ref[:, i]).abs().max()) < F32_BOUND, i
