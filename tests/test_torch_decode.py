"""The port's KV-cache decode (``repro_torch.models.decode``) and its
serving runner (``repro_torch.launch.serve.ModelRunner``) on the CPU:

- the port's own decode against its teacher-forced forward, as the
  reference's ``test_decode_matches_forward`` (fp32, 2e-4);
- the port's ``decode_step`` logits and caches against the reference's for
  8 steps, the reference's parameters carried across, fp32 at 2e-4 and
  bf16 at ``BF16_BOUND``;
- the ring-buffer branch at a window of 16, past the wrap;
- ``ModelRunner`` teacher-forced with the reference runner's tokens.

bf16 bound, measured on these inputs: the logits differ by at most 0.0056
at magnitude <= 0.95 (0.0056 of max(1, |logit|)); the caches by 0.0156
(one bf16 ulp at magnitude 2-4; 0.0057 of their scale); the runner's
logits by 0.0044 at magnitude <= 0.77, and its 128 next tokens all
agree.  So ``BF16_BOUND`` is 0.02 of max(1, max |reference|): under 4x
the measured 0.0057 and under 0.1 of the logits' magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.models import decode as JD
from repro.models import model as JM
from repro.models import schema as JS
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import ModelRunner
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import schema as S

KEY = jax.random.PRNGKey(1)
F32_BOUND = 2e-4
BF16_BOUND = 0.02
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype, **kw):
    jdt, tdt = DTYPES[dtype]
    ref = dataclasses.replace(jax_smoke_config(jax_get_config(arch)), compute_dtype=jdt, **kw)
    got = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=tdt, **kw)
    return ref, got


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bound(ref: np.ndarray, dtype: str) -> float:
    return F32_BOUND if dtype == "f32" else BF16_BOUND * max(1.0, float(np.abs(ref).max()))


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen15_05b", "llama3_8b", "gemma_7b"])
def test_decode_matches_forward(arch):
    """MHA + qkv bias + tied embeddings (qwen), GQA (llama), GeGLU with
    head_dim != d/H (gemma): stepwise decode reproduces the teacher-forced
    forward's logits (fp32, the port's own ``init_params``)."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=torch.float32)
    params = S.init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    b, t = 2, 8
    toks = torch.from_numpy(_tokens(cfg, b, t))
    hid, _ = M.forward(params, {"tokens": toks}, cfg)
    ref = L.unembed_logits(M._unembed_table(params, cfg), hid, cfg)
    cache = D.init_cache(cfg, b, t, "cpu")
    for i in range(t):
        logits, cache = D.decode_step(params, cache, {"tokens": toks[:, i:i + 1], "pos": i}, cfg)
        err = float((logits - ref[:, i]).abs().max())
        assert err < 2e-4, (arch, i, err)


def _decode_both(arch, dtype, steps, window=0):
    """The reference's and the port's decode over the same tokens, with the
    reference's parameters: yields (step, ref logits, port logits, ref
    cache, port cache)."""
    kw = dict(attn_window=window) if window else {}
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    params = JS.init_params(JM.model_schema(jcfg), KEY)
    tp = S.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    b = 2
    toks = _tokens(jcfg, b, steps, seed=2)
    jstep = jax.jit(lambda p, c, bt: JD.decode_step(p, c, bt, jcfg))
    jc, tc = JD.init_cache(jcfg, b, steps), D.init_cache(tcfg, b, steps, "cpu")
    for i in range(steps):
        jl, jc = jstep(params, jc, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                    "pos": jnp.asarray(i, jnp.int32)})
        tl, tc = D.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, i:i + 1]),
                                        "pos": i}, tcfg)
        yield i, _np(jl), tl, jc, tc, (tp, tcfg, toks)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["qwen15_05b", "llama3_8b", "gemma_7b",
                                  "llava_next_mistral_7b"])
def test_decode_step_matches_reference(arch, dtype):
    """8 steps: logits and both caches against the reference's."""
    for i, jl, tl, jc, tc, _ in _decode_both(arch, dtype, 8):
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        assert float(np.abs(tl.numpy() - jl).max()) <= _bound(jl, dtype), (i, dtype)
        for k in ("k", "v"):
            assert tc[k].dtype == getattr(torch, jnp.dtype(jc[k].dtype).name)
            ref = _np(jc[k])
            assert float(np.abs(_np(tc[k]) - ref).max()) <= _bound(ref, dtype), (i, k)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ring_buffer_past_the_wrap(dtype):
    """A window of 16 over 24 steps: slot = pos % 16 overwrites the first
    cycle.  The logits match the reference's at every step, and the
    teacher-forced windowed forward while the cache still holds every
    position (the reference test's comparison)."""
    fwd = None
    for i, jl, tl, jc, tc, (tp, tcfg, toks) in _decode_both("llama3_8b", dtype, 24, window=16):
        assert D.cache_len(tcfg, 24) == 16 and tc["k"].shape[2] == 16
        assert float(np.abs(tl.numpy() - jl).max()) <= _bound(jl, dtype), i
        if fwd is None:
            hid, _ = M.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
            fwd = L.unembed_logits(M._unembed_table(tp, tcfg), hid, tcfg)
        if dtype == "f32" and i < 16:
            assert float((tl - fwd[:, i]).abs().max()) < 2e-4, i
        for k in ("k", "v"):
            ref = _np(jc[k])
            assert float(np.abs(_np(tc[k]) - ref).max()) <= _bound(ref, dtype), (i, k)


def test_cache_spec_and_refusals():
    """Every arch's cache at the smoke size: the reference's names, shapes
    and dtypes (k / v, the latents, the SSM states in fp32 and the conv
    windows, the hybrid's groups and ring buffers); nothing is refused."""
    for arch in jax_configs.list_archs():
        cfg = smoke_config(get_config(arch))
        spec = D.cache_spec(cfg, 3, 40)
        ref = JD.cache_spec(jax_smoke_config(jax_get_config(arch)), 3, 40)
        assert set(spec) == set(ref), arch
        for k, (shape, dt) in spec.items():
            assert (shape, dt) == (ref[k].shape, getattr(torch, jnp.dtype(ref[k].dtype).name))
        cache = D.init_cache(cfg, 3, 40, "cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == spec, arch
        assert all(not v.any() for v in cache.values())


def test_language_model_decode_step():
    """The module's ``decode_step`` is the function's."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen15_05b")), compute_dtype=torch.float32)
    lm = M.LanguageModel(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.ones((2, 1), dtype=torch.int32)
    a, ca = lm.decode_step(D.init_cache(cfg, 2, 4, "cpu"), toks, 0)
    b, cb = D.decode_step(lm.tree(), D.init_cache(cfg, 2, 4, "cpu"), {"tokens": toks, "pos": 0},
                          cfg)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])


def test_model_runner_matches_reference_runner():
    """The reference runner (bf16, smoke qwen, 16 lanes) for 8 ticks, its
    tokens teacher-forced into the port's runner built on its parameters:
    logits within the bf16 bound, and the port's next tokens equal the
    reference's wherever the reference's top-2 margin exceeds that bound."""
    ref = jax_serve.ModelRunner("qwen15_05b", 16)
    logits = []
    step = ref._step

    def spy(p, c, b):
        out, c = step(p, c, b)
        logits.append(np.asarray(out))
        return out, c

    ref._step = spy
    got = ModelRunner("qwen15_05b", 16, device="cpu",
                      params=S.params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu"))
    assert got.cache["k"].shape == ref.cache["k"].shape and got.max_len == ref.max_len == 64
    compared = 0
    for i in range(8):
        got.tokens = torch.from_numpy(np.array(ref.tokens))
        ref.tick()
        got.tick()
        assert got.pos == ref.pos == i + 1
        jl = logits[-1]
        bound = _bound(jl, "bf16")
        assert float(np.abs(got.logits.numpy() - jl).max()) <= bound, i
        top2 = np.sort(jl, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > bound
        want = np.asarray(ref.tokens)[:, 0]
        assert np.array_equal(got.tokens.numpy()[clear, 0], want[clear]), i
        compared += int(clear.sum())
    assert compared > 0


def test_model_runner_stops_at_max_len_and_argmax_ties():
    runner = ModelRunner("llama3_8b", 4, max_len=3, device="cpu")
    assert runner.tokens.dtype == torch.int32 and bool((runner.tokens == 1).all())
    for _ in range(5):
        runner.tick()
    assert runner.pos == 3
    assert torch.argmax(torch.tensor([[0.0, 2.0, 2.0]]), -1).item() == 1  # first maximum


def test_model_runner_needs_a_card_by_default(monkeypatch):
    """Without a card the runner raises unless asked for the CPU, for every
    family; asked for the CPU, it runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("qwen15_05b", "deepseek_v2_lite_16b", "mamba2_13b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelRunner(arch, 4)
    runner = ModelRunner("deepseek_v2_lite_16b", 4, max_len=2, device="cpu")
    runner.tick()
    assert runner.pos == 1 and runner.logits.device.type == "cpu"
