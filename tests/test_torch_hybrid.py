"""The hybrid family (zamba2: groups of SSD blocks, then one shared-weight
attention block over its own per-group ring buffer, then a tail) against
the reference on the CPU, and what the four later families share: the
caches' specs, a leading-dense-layer model without MLA (``dense_k`` /
``dense_v``), ``compute_params`` with the fp32-read leaves perturbed, the
per-leaf build, and ``ModelRunner`` against the reference runner.
Tolerances and routing rules are in ``torch_lm_parity``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
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
from torch_lm_parity import (
    DTYPES,
    F32_BOUND,
    KEY,
    Routing,
    bound,
    carry,
    cfgs,
    decode_mask,
    model_parity,
    perturb,
    tokens,
)

FAMILIES = ("arctic_480b", "deepseek_v2_lite_16b", "mamba2_13b", "zamba2_7b")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("steps", [8, 24])
def test_zamba2_model_matches_reference(steps, dtype, monkeypatch):
    """forward (two chunks), logits_last, and decode within the smoke
    window of 16 and past its wrap (t = 24: slot = pos % 16 overwrites the
    first cycle): the groups' and the tail's SSM caches and the shared
    block's ring buffers."""
    model_parity("zamba2_7b", dtype, monkeypatch, b=2, s=16, steps=steps)


@pytest.mark.parametrize("steps", [8, 24])
def test_zamba2_decode_matches_forward(steps):
    """The port's own decode reproduces its teacher-forced windowed forward
    (fp32) while the ring buffer holds every position the window sees."""
    cfg = dataclasses.replace(smoke_config(get_config("zamba2_7b")), compute_dtype=torch.float32)
    params = S.init_params(M.model_schema(cfg), torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    hid, _ = M.forward(params, {"tokens": toks}, cfg)
    ref = L.unembed_logits(M._unembed_table(params, cfg), hid, cfg)
    cache = D.init_cache(cfg, 2, steps, "cpu")
    assert cache["attn_k"].shape[2] == D.cache_len(cfg, steps) == min(steps, 16)
    for i in range(steps):
        logits, cache = D.decode_step(params, cache, {"tokens": toks[:, i:i + 1], "pos": i}, cfg)
        assert float((logits - ref[:, i]).abs().max()) < F32_BOUND, i


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_blocks_without_mla_match_reference(dtype, monkeypatch):
    """DeepSeek's layout with GQA attention in place of MLA: the leading
    dense layer's ``dense_k`` / ``dense_v`` cache branch."""
    shares = model_parity("deepseek_v2_lite_16b", dtype, monkeypatch, b=2, s=16, mla=None)
    assert shares["lane_steps"] > 0


@pytest.mark.parametrize("cache_dtype", [None, "float8_e4m3fn"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_spec_matches_reference_at_full_width(arch, cache_dtype):
    """The published configs' caches (no allocation): names, shapes and
    dtypes; the SSM state stays fp32 under an fp8 cache dtype."""
    ref_cfg, cfg = jax_get_config(arch), get_config(arch)
    if cache_dtype:
        ref_cfg = dataclasses.replace(ref_cfg, cache_dtype=getattr(jnp, cache_dtype))
        cfg = dataclasses.replace(cfg, cache_dtype=getattr(torch, cache_dtype))
    for batch, seq in ((128, 32_768), (1, 524_288), (3, 40)):
        ref, got = JD.cache_spec(ref_cfg, batch, seq), D.cache_spec(cfg, batch, seq)
        assert set(got) == set(ref)
        for k, (shape, dt) in got.items():
            assert (shape, dt) == (ref[k].shape, getattr(torch, jnp.dtype(ref[k].dtype).name)), k


def _smoke_tree(arch, seed=0):
    jcfg, tcfg = cfgs(arch, "bf16")
    params = perturb(JS.init_params(JM.model_schema(jcfg), KEY), seed)
    return tcfg, carry(params)


@pytest.mark.parametrize("arch", FAMILIES)
def test_compute_params_are_the_per_use_casts(arch):
    """``compute_params`` keeps the leaves read in fp32 (norm scales,
    ``kv_norm``, the SSM's ``norm``, ``A_log``, ``D``, ``dt_bias``) in their
    parameter dtype, so a forward and a decode step on the cast tree are
    bitwise those on the parameter-dtype tree (bf16 compute, perturbed
    leaves: the ones and zeros they init to would hide a wrong cast)."""
    cfg, tp = _smoke_tree(arch)
    cp = M.compute_params(tp, cfg)
    for path, _ in S._leaf_paths(M.model_schema(cfg)):
        a, b = tp, cp
        for p in path:
            a, b = a[p], b[p]
        want = a.dtype if path[-1] in M.FP32_READ else cfg.compute_dtype
        assert b.dtype == want, path
    toks = torch.from_numpy(tokens(cfg, 2, 16))
    assert torch.equal(M.forward(cp, {"tokens": toks}, cfg)[0],
                       M.forward(tp, {"tokens": toks}, cfg)[0])
    caches = [D.init_cache(cfg, 2, 4, "cpu") for _ in range(2)]
    for i in range(3):
        a, _ = D.decode_step(cp, caches[0], {"tokens": toks[:, i:i + 1], "pos": i}, cfg)
        b, _ = D.decode_step(tp, caches[1], {"tokens": toks[:, i:i + 1], "pos": i}, cfg)
        assert torch.equal(a, b), i
    assert all(torch.equal(caches[0][k], caches[1][k]) for k in caches[0])


@pytest.mark.parametrize("arch", FAMILIES)
def test_per_leaf_build_is_draw_then_cast(arch):
    """``init_compute_params`` (each leaf cast as it is drawn) is bitwise
    ``compute_params(init_params(...))`` from the same generator seed, and
    is what ``ModelRunner`` holds."""
    cfg = smoke_config(get_config(arch))
    got = M.init_compute_params(cfg, torch.Generator().manual_seed(5), "cpu")
    want = M.compute_params(S.init_params(M.model_schema(cfg), torch.Generator().manual_seed(5),
                                          "cpu"), cfg)
    pairs = list(zip(S.tree_leaves(got), S.tree_leaves(want)))
    assert len(pairs) == len(list(S._leaf_paths(M.model_schema(cfg))))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    runner = ModelRunner(arch, 4, device="cpu", seed=5)
    assert all(torch.equal(a, b) for a, b in zip(S.tree_leaves(runner.weights),
                                                 S.tree_leaves(got)))


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "mamba2_13b"])
def test_model_runner_matches_reference_runner(arch, monkeypatch):
    """The reference runner (bf16 smoke config, 16 lanes) for 8 ticks, its
    tokens teacher-forced into the port's runner built on its parameters:
    logits within the bf16 bound, and the port's next tokens equal the
    reference's wherever the reference's top-2 margin exceeds that bound.
    DeepSeek's reference step runs eagerly with the routing spies, and its
    lanes are compared until their routing first differs."""
    ref = jax_serve.ModelRunner(arch, 16)
    routing = None
    if ref.cfg.moe is not None:
        ref.cfg = dataclasses.replace(ref.cfg, scan_layers=False)
        ref._step = lambda p, c, b: JD.decode_step(p, c, b, ref.cfg)
        routing = Routing(monkeypatch)
    logits = []
    step = ref._step

    def spy(p, c, b):
        out, c = step(p, c, b)
        logits.append(np.asarray(out))
        return out, c

    ref._step = spy
    got = ModelRunner(arch, 16, device="cpu",
                      params=S.params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu"))
    assert set(got.cache) == set(ref.cache) and got.max_len == ref.max_len == 64
    ours, theirs = [], []
    for i in range(8):
        got.tokens = torch.from_numpy(np.array(ref.tokens))
        ref.tick()
        got.tick()
        assert got.pos == ref.pos == i + 1
        ours.append(got.logits.numpy().copy())
        theirs.append(np.asarray(ref.tokens)[:, 0])
    lanes = np.ones((8, 16), bool) if routing is None else \
        decode_mask(routing.clean(ref.cfg, "bf16"), 8, 16)
    assert lanes.mean() >= 0.5
    compared = 0
    for i in range(8):
        jl, ok = logits[i][lanes[i]], lanes[i]
        assert float(np.abs(ours[i][ok] - jl).max()) <= bound(jl, "bf16"), i
        top2 = np.sort(jl, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > bound(jl, "bf16")
        assert np.array_equal(ours[i][ok].argmax(-1)[clear], theirs[i][ok][clear]), i
        compared += int(clear.sum())
    assert compared > 0
    for k in got.cache:
        assert got.cache[k].dtype == getattr(torch, jnp.dtype(ref.cache[k].dtype).name)


def test_forward_reports_the_moe_aux_loss():
    """The aux loss sums the MoE layers' (deepseek: one routed layer of two;
    the dense leading layer adds nothing), and is 0 without MoE."""
    cfg, tp = _smoke_tree("deepseek_v2_lite_16b")
    toks = torch.from_numpy(tokens(cfg, 2, 16))
    _, aux = M.forward(tp, {"tokens": toks}, cfg)
    x = L.embed_apply(tp["embed"], toks, cfg)
    pos = torch.arange(16, dtype=torch.int32)
    x = M._dense_block_apply(M.layer_views(tp["dense_blocks"])[0], x, cfg, pos)
    _, want = M._attn_block_apply(M.layer_views(tp["blocks"])[0], x, cfg, pos)
    assert float(aux) == float(want) > 0
    cfg, tp = _smoke_tree("zamba2_7b")
    assert float(M.forward(tp, {"tokens": toks}, cfg)[1]) == 0.0
