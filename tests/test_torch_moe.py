"""The port's MoE layer (``repro_torch.models.moe``) and the MoE model
without MLA (arctic: 128 -> 8 experts at the smoke size, top 2, a parallel
dense branch) against the reference's (``repro.models.moe``) on the CPU,
the reference's parameters carried across: both dispatches, the aux loss,
the uniform router's tie order, drops under skew, the shared and dense
branches, einsum equal to sort.  Tolerances and routing rules are in
``torch_lm_parity``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JMOE
from repro.models import schema as JS
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import schema as S
from torch_lm_parity import DTYPES, F32_BOUND, carry, close, model_parity, np_, randn

KEY = jax.random.PRNGKey(0)
VARIANTS = {"routed": {}, "shared": {"shared_experts": 2}, "dense": {"dense_parallel": True}}


def _cfgs(dtype="f32", **moe_kw):
    """The reference test's layer config (``tests/test_moe.py``): 8 experts,
    top 2, d_model 16, groups of 16."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(name="t", family="moe", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
              d_ff=32, vocab_size=64)
    moe = dict(num_experts=8, top_k=2, expert_d_ff=32, group_size=16, **moe_kw)
    return (JModelConfig(moe=JMoEConfig(**moe), compute_dtype=jdt, **kw),
            ModelConfig(moe=MoEConfig(**moe), compute_dtype=tdt, **kw))


def _both(jcfg, tcfg, x, params=None):
    params = JS.init_params(JMOE.moe_schema(jcfg), KEY) if params is None else params
    jdt = jcfg.compute_dtype
    ry, raux = JMOE.moe_apply(params, jnp.asarray(x, jdt), jcfg)
    gy, gaux = MOE.moe_apply(carry(params), torch.from_numpy(x).to(tcfg.compute_dtype), tcfg)
    return (ry, raux), (gy, gaux), params


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_apply_matches_reference(dispatch, dtype, variant):
    """Two groups of 16 tokens at the default capacity (drops happen):
    output and aux loss."""
    jcfg, tcfg = _cfgs(dtype, dispatch=dispatch, **VARIANTS[variant])
    x = randn(2, 16, 16, seed=3)
    (ry, raux), (gy, gaux), params = _both(jcfg, tcfg, x)
    assert gy.dtype == tcfg.compute_dtype and gy.shape == (2, 16, 16)
    close(gy, ry, dtype)
    assert gaux.dtype == torch.float32
    assert abs(float(gaux) - float(raux)) <= 1e-6


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_uniform_router_picks_the_lower_experts(dispatch):
    """A zero router makes every probability 1/E: the top 2 are experts 0
    and 1 for every token, as ``jax.lax.top_k`` breaks ties, and the output
    and the aux loss (= the coefficient) match the reference's."""
    jcfg, tcfg = _cfgs(dispatch=dispatch)
    params = JS.init_params(JMOE.moe_schema(jcfg), KEY)
    params["router"] = jnp.zeros_like(params["router"])
    x = randn(2, 16, 16, seed=4)
    (ry, raux), (gy, gaux), _ = _both(jcfg, tcfg, x, params)
    _, gate, idx = MOE.route(carry(params), torch.from_numpy(x).reshape(2, 16, 16), tcfg)
    assert torch.equal(idx, torch.tensor([0, 1]).expand(2, 16, 2))
    assert torch.equal(gate, torch.full((2, 16, 2), 0.5))
    close(gy, ry, "f32")
    assert float(gaux) == pytest.approx(MOE.AUX_LOSS_COEF, rel=1e-3)
    assert abs(float(gaux) - float(raux)) <= 1e-7


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_capacity_drops_under_skew(dispatch):
    """Every token wants expert 0 (``tests/test_moe.py:72``): capacity
    ceil(16 * 2 * 1.0 / 8) = 4 keeps the first 4 tokens' assignments and
    drops the rest, as the reference does."""
    jcfg, tcfg = _cfgs(dispatch=dispatch, capacity_factor=1.0)
    params = JS.init_params(JMOE.moe_schema(jcfg), KEY)
    r = np.zeros((16, 8), np.float32)
    r[:, 0] = 10.0
    params["router"] = jnp.asarray(r)
    x = randn(1, 16, 16, seed=5)
    (ry, raux), (gy, gaux), _ = _both(jcfg, tcfg, x, params)
    close(gy, ry, "f32")
    norms = np.linalg.norm(np_(gy).reshape(16, 16), axis=-1)
    assert (norms < 1e-6).sum() >= 8
    assert float(gaux) > MOE.AUX_LOSS_COEF
    assert abs(float(gaux) - float(raux)) <= 1e-6


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 16.0])
def test_einsum_equals_sort(capacity_factor, dtype):
    """The two dispatches keep the same assignments and compute the same
    output (three groups; drops at the low capacities)."""
    _, tcfg = _cfgs(dtype, capacity_factor=capacity_factor, shared_experts=1)
    params = S.init_params(MOE.moe_schema(tcfg), torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(randn(3, 16, 16, seed=6)).to(tcfg.compute_dtype)
    ye, ae = MOE.moe_apply(params, x, tcfg)
    ys, as_ = MOE.moe_apply(params, x, dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, dispatch="sort")))
    close(ys, ye, dtype)
    assert float(ae) == float(as_)


def test_high_capacity_is_the_dense_top_k_mixture():
    """With capacity factor 16 nothing drops: the output is each token's
    gate-weighted sum of its top-2 experts' gated MLPs (the reference
    test's manual loop)."""
    _, tcfg = _cfgs(capacity_factor=16.0)
    p = S.init_params(MOE.moe_schema(tcfg), torch.Generator().manual_seed(1), "cpu")
    x = torch.from_numpy(randn(1, 16, 16, seed=7))
    y, _ = MOE.moe_apply(p, x, tcfg)
    xt = x.reshape(16, 16)
    gate, idx = torch.topk(torch.softmax(xt @ p["router"], -1), 2)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.zeros(16, 16)
    for t in range(16):
        for j in range(2):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(xt[t] @ p["w_gate"][e]) * (xt[t] @ p["w_up"][e])
            want[t] += gate[t, j] * (h @ p["w_down"][e])
    assert float((y.reshape(16, 16) - want).abs().max()) <= F32_BOUND


def test_shared_and_dense_branches_are_live():
    jcfg, tcfg = _cfgs(shared_experts=2, dense_parallel=True)
    params = JS.init_params(JMOE.moe_schema(jcfg), KEY)
    x = torch.from_numpy(randn(2, 16, 16, seed=8))
    y, _ = MOE.moe_apply(carry(params), x, tcfg)
    for branch in ("shared", "dense"):
        p = carry(params)
        p[branch] = {k: torch.zeros_like(v) for k, v in p[branch].items()}
        assert float((MOE.moe_apply(p, x, tcfg)[0] - y).abs().max()) > 1e-6, branch


def test_tokens_must_fill_the_groups():
    _, tcfg = _cfgs()
    p = S.init_params(MOE.moe_schema(tcfg), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="group_size"):
        MOE.moe_apply(p, torch.zeros(3, 7, 16), tcfg)
    y, _ = MOE.moe_apply(p, torch.zeros(3, 1, 16), tcfg)  # decode: 3 lanes, one group of 3
    assert y.shape == (3, 1, 16)


# ---------------------------------------------------------------------------
# the MoE model (arctic: GQA attention, MoE with a parallel dense branch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("capacity_factor", [None, 16.0])
def test_arctic_model_matches_reference(capacity_factor, dtype, monkeypatch):
    """forward, logits_last and 8 decode steps, at the published capacity
    factor (drops) and at 16 (none)."""
    moe = {"capacity_factor": capacity_factor} if capacity_factor else None
    model_parity("arctic_480b", dtype, monkeypatch, b=2, s=16, moe=moe)


def test_arctic_decode_matches_forward():
    """The port's own decode reproduces its teacher-forced forward (fp32,
    capacity factor 16 as the reference's decode test: nothing dropped)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import decode as D
    from repro_torch.models import layers as L

    cfg = smoke_config(get_config("arctic_480b"))
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    params = S.init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    hid, _ = M.forward(params, {"tokens": toks}, cfg)
    ref = L.unembed_logits(M._unembed_table(params, cfg), hid, cfg)
    cache = D.init_cache(cfg, 2, 8, "cpu")
    for i in range(8):
        logits, cache = D.decode_step(params, cache, {"tokens": toks[:, i:i + 1], "pos": i}, cfg)
        assert float((logits - ref[:, i]).abs().max()) < F32_BOUND, i
