"""The port's LM layers and models (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU at the smoke configs, with the
reference's parameters carried across (``schema.params_from_numpy``) and
the same numpy inputs.

fp32 compute holds at 2e-4 absolute (the reference's decode bound; the
largest error measured here is 2.6e-6).  bf16 compute holds at
``BF16_BOUND`` x max(1, max |reference|).  Measured on these inputs: at
most 0.0095 of that scale (0.03125, two bf16 ulps, on llama's hidden
states of magnitude 3.30); 0.0045 on the last-position logits (magnitude
<= 0.93).  So the bound is 0.025: under 4x the measured 0.0095 and under
0.1 of the logits' magnitude.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import schema as JS
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import schema as S

KEY = jax.random.PRNGKey(1)
F32_BOUND = 2e-4
BF16_BOUND = 0.025
ARCHS = ("qwen15_05b", "llama3_8b", "gemma_7b", "stablelm_12b", "llava_next_mistral_7b",
         "hubert_xlarge")
#: every arch: the MoE, MLA, SSM and hybrid families' layers are in
#: ``test_torch_{moe,mla,ssm,hybrid}.py``
ALL_ARCHS = ARCHS + ("arctic_480b", "deepseek_v2_lite_16b", "mamba2_13b", "zamba2_7b")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype, **kw):
    jdt, tdt = DTYPES[dtype]
    ref = dataclasses.replace(jax_smoke_config(jax_get_config(arch)), compute_dtype=jdt, **kw)
    got = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=tdt, **kw)
    return ref, got


def _carry(params):
    return S.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, dtype: str) -> float:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    scale = 1.0 if dtype == "f32" else max(1.0, float(np.abs(ref).max()))
    bound = F32_BOUND if dtype == "f32" else BF16_BOUND * scale
    assert err <= bound, (err, bound)
    return err


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _randn(2, 5, 128) * 3
    scale = 1 + _randn(128, seed=1) * 0.1
    ref = JL.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x, jdt))
    got = L.rmsnorm_apply({"scale": torch.from_numpy(scale)}, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, ref, dtype)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 1_000_000.0])
def test_rope(theta):
    """Half-split rotation at positions up to 32,767, both head widths."""
    for d in (32, 64, 256):
        np.testing.assert_allclose(L.rope_freqs(d, theta).numpy(),
                                   np.asarray(JL.rope_freqs(d, theta)), rtol=1e-6, atol=0)
        x = _randn(2, 8, 4, d)
        pos = np.array([0, 1, 5, 17, 100, 1000, 4095, 32767], np.int32)
        ref = JL.rope_apply(jnp.asarray(x), jnp.asarray(pos), theta)
        got = L.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), theta)
        _close(got, ref, "f32")
        ref = JL.rope_apply(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), theta)
        got = L.rope_apply(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos), theta)
        _close(got, ref, "bf16")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embed_and_unembed(dtype):
    """The gather is bitwise the reference's cast-then-gather; the
    unembedding returns fp32 (fp32 accumulation of compute-dtype values)."""
    jcfg, tcfg = _cfgs("qwen15_05b", dtype)
    table = _randn(jcfg.padded_vocab, jcfg.d_model, scale=0.02)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    ref = JL.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(toks), jcfg)
    got = L.embed_apply({"table": torch.from_numpy(table)}, torch.from_numpy(toks), tcfg)
    assert got.dtype == tcfg.compute_dtype and np.array_equal(_np(got), _np(ref))
    h = _randn(4, jcfg.d_model)
    ref = JL.unembed_logits(jnp.asarray(table), jnp.asarray(h), jcfg)
    got = L.unembed_logits(torch.from_numpy(table), torch.from_numpy(h), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, jcfg.padded_vocab)
    _close(got, ref, "f32")  # fp32 results either way


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["llama3_8b", "gemma_7b", "hubert_xlarge"])
def test_mlp_variants(arch, dtype):
    """SwiGLU (llama), GeGLU (gemma) and the plain GELU MLP (hubert)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    params = JS.init_params(JL.mlp_schema(jcfg), KEY)
    x = _randn(2, 6, jcfg.d_model)
    ref = JL.mlp_apply(params, jnp.asarray(x), jcfg)
    got = L.mlp_apply(_carry(params), torch.from_numpy(x), tcfg)
    assert got.dtype == tcfg.compute_dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["causal", "window", "kv_len", "bidirectional"])
def test_gqa_attend(case, dtype):
    """4 query heads over 2 KV heads, fp32 scores and softmax."""
    jdt, tdt = DTYPES[dtype]
    sq, skv = (1, 12) if case == "kv_len" else (12, 12)
    q, k, v = _randn(2, sq, 4, 32, seed=1), _randn(2, skv, 2, 32, seed=2), _randn(2, skv, 2, 32, seed=3)
    qpos = np.array([7], np.int32) if case == "kv_len" else np.arange(12, dtype=np.int32)
    kvpos = np.arange(skv, dtype=np.int32)
    kw = dict(causal=case != "bidirectional", window=5 if case == "window" else 0)
    ref = JL.gqa_attend(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos),
                        kv_len=jnp.asarray(8) if case == "kv_len" else None, **kw)
    got = L.gqa_attend(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kvpos),
                       kv_len=8 if case == "kv_len" else None, **kw)
    assert got.dtype == tdt
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["qwen15_05b", "llama3_8b", "gemma_7b"])
def test_attention_apply(arch, dtype):
    """QKV bias (qwen), GQA (llama), head_dim != d/H (gemma)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    params = JS.init_params(JL.attention_schema(jcfg), KEY)
    if jcfg.qkv_bias:  # the biases init to zero: give them values
        params = {k: v + 0.1 if k.startswith("b") else v for k, v in params.items()}
    x = _randn(2, 9, jcfg.d_model)
    pos = jnp.arange(9, dtype=jnp.int32)
    ref = JL.attention_apply(params, jnp.asarray(x), jcfg, pos)
    got = L.attention_apply(_carry(params), torch.from_numpy(x), tcfg,
                            torch.arange(9, dtype=torch.int32))
    _close(got, ref, dtype)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=8):
    rng = np.random.default_rng(5)
    if cfg.frontend == "frames":
        return {"frames": rng.standard_normal((b, s, M.FRAME_DIM)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "patch":
        out["patches"] = rng.standard_normal((b, cfg.frontend_tokens, M.PATCH_DIM)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits_last(arch, dtype):
    """Hidden states and last-position logits at the smoke config: llava
    with its patches prepended, hubert on frames, bidirectional."""
    jcfg, tcfg = _cfgs(arch, dtype)
    params = JS.init_params(JM.model_schema(jcfg), KEY)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = _carry(params)
    ref_h, ref_aux = JM.forward(params, jbatch, jcfg)
    got_h, got_aux = M.forward(tp, tbatch, tcfg)
    assert float(got_aux) == float(ref_aux) == 0.0
    assert got_h.dtype == tcfg.compute_dtype
    _close(got_h, ref_h, dtype)
    ref = JM.logits_last(params, jbatch, jcfg)
    got = M.logits_last(tp, tbatch, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, jcfg.padded_vocab)
    _close(got, ref, dtype)
    # the module face computes the same
    lm = M.LanguageModel(tcfg, tp)
    assert torch.equal(lm.logits_last(tbatch), got)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_shapes_dtypes_and_draws(arch):
    """The same shapes and dtypes as the reference's ``abstract_params``;
    zeros and ones exact; each drawn leaf's std within 5 % of its rule."""
    jcfg = jax_smoke_config(jax_get_config(arch))
    cfg = smoke_config(get_config(arch))
    sch = M.model_schema(cfg)
    ref = jax.tree_util.tree_flatten_with_path(JS.abstract_params(JM.model_schema(jcfg)))[0]
    gen = torch.Generator().manual_seed(0)
    params = S.init_params(sch, gen, "cpu")
    abstract = S.abstract_params(sch)
    leaves = dict(S._leaf_paths(sch))
    assert len(leaves) == len(ref)
    for path, r in ref:
        keys = tuple(p.key for p in path)
        node, meta = params, abstract
        for k in keys:
            node, meta = node[k], meta[k]
        want = (tuple(r.shape), getattr(torch, jnp.dtype(r.dtype).name))
        assert (tuple(node.shape), node.dtype) == want == (tuple(meta.shape), meta.dtype)
        assert meta.device.type == "meta"
        pd = leaves[keys]
        if pd.init in ("zeros", "ones"):
            assert torch.equal(node, torch.full_like(node, float(pd.init == "ones")))
            continue
        std = (0.02 if pd.init == "embed" else float(pd.init.split(":")[1])
               if pd.init.startswith("normal:") else 1 / math.sqrt(pd.shape[pd.fan_axis]))
        assert abs(float(node.float().std()) / std - 1) < 0.05, (keys, pd.init)
    assert S.param_count(sch) == JS.param_count(JM.model_schema(jcfg))
    assert S.param_bytes(sch) == JS.param_bytes(JM.model_schema(jcfg))


def test_init_params_follows_the_generator():
    sch = M.model_schema(smoke_config(get_config("qwen15_05b")))
    a = S.init_params(sch, torch.Generator().manual_seed(3), "cpu")
    b = S.init_params(sch, torch.Generator().manual_seed(3), "cpu")
    c = S.init_params(sch, torch.Generator().manual_seed(4), "cpu")
    flat = lambda t: torch.cat([x.flatten() for x in S.tree_leaves(t)])  # noqa: E731
    assert torch.equal(flat(a), flat(b)) and not torch.equal(flat(a), flat(c))


def test_params_round_trip_and_module_tree():
    """The reference's tree carries across and back, bf16 leaves too
    (arctic's parameter dtype), and ``LanguageModel`` holds it unchanged
    with no gradient."""
    jcfg = dataclasses.replace(jax_smoke_config(jax_get_config("llama3_8b")),
                               param_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, JS.init_params(JM.model_schema(jcfg), KEY))
    tp = S.params_from_numpy(params, "cpu")
    assert tp["embed"]["table"].dtype == torch.bfloat16
    back = S.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint16), b.view(np.uint16))
    cfg = dataclasses.replace(smoke_config(get_config("llama3_8b")), param_dtype=torch.bfloat16)
    lm = M.LanguageModel(cfg, tp)
    assert not any(p.requires_grad for p in lm.parameters())
    tree = lm.tree()
    assert all(torch.equal(tree["blocks"]["attn"][k], tp["blocks"]["attn"][k])
               for k in tp["blocks"]["attn"])
    assert sum(p.numel() for p in lm.parameters()) == S.param_count(M.model_schema(cfg))


def test_compute_params_cast_once():
    """Every weight in the compute dtype but the norm scales (fp32), so a
    forward on the copy is bitwise a forward on the fp32 weights."""
    cfg = smoke_config(get_config("qwen15_05b"))
    tp = _carry(JS.init_params(JM.model_schema(jax_smoke_config(jax_get_config("qwen15_05b"))),
                               KEY))
    cp = M.compute_params(tp, cfg)
    assert cp["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert cp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    batch = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    assert torch.equal(M.logits_last(cp, batch, cfg), M.logits_last(tp, batch, cfg))
