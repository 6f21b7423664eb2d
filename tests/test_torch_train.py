"""The port's training pieces (``repro_torch.models.layers.chunked_ce_loss``,
``model.loss_fn`` / ``_maybe_remat``, ``train/optimizer.py`` and
``train/loop.py``) against the reference's on the CPU, with the reference's
parameters carried across and inputs from numpy seeds.

Tolerances (fp32): the CE and the loss within 2e-5 (measured 0 to 4.8e-7
at losses near 6.3); AdamW's parameters, moments and grad norm within
1e-6 relative over 5 steps, bf16 leaves and moments too (the same
arithmetic in the same order; measured bitwise equal here, the bound
leaves room for another ``pow``); a train step's parameters and first
moments within 2e-6 absolute of the reference's (measured 2.7e-7 and
5.1e-9: the first AdamW step moves a parameter by lr x g / (|g| + eps),
so a gradient that is zero up to rounding can move it either way by the
warmed-up lr, 1e-5 here).  Remat is bitwise: on the CPU a recomputed
product equals the first.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_lm_parity as P
from repro.data.pipeline import batches as jax_batches
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import schema as JS
from repro.train import loop as JTL
from repro.train import optimizer as JO
from repro_torch.data.pipeline import batches
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.schema import tree_items
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as O

LOSS_ATOL = 2e-5
OPT_RTOL = 1e-6
STEP_ATOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch work on one intra-op thread: the smoke models'
    ops are small, and under parallel test workers extra threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**kw):
    """The reference test's tiny config (qwen smoke, vocab 128, chunk 16),
    on both sides."""
    jcfg, tcfg = P.cfgs("qwen15_05b", "f32", vocab_size=128, loss_chunk=16, **kw)
    return jcfg, tcfg


def _flat(tree) -> dict:
    """Leaves by path, as fp32 numpy (either side's tree)."""
    return {"/".join(p): P.np_(v) for p, v in tree_items(tree)}


# ---------------------------------------------------------------------------
# chunked CE and loss_fn
# ---------------------------------------------------------------------------


def test_chunked_ce_loss_matches_reference():
    """Padded vocab (503 -> 512) and ignored labels, over several chunks; a
    batch of only ignored labels gives 0, not a division by zero."""
    jcfg, tcfg = P.cfgs("llama3_8b", "f32")
    rng = np.random.default_rng(5)
    table = P.randn(jcfg.padded_vocab, jcfg.d_model, seed=6, scale=0.05)
    hidden = P.randn(2, 48, jcfg.d_model, seed=7)
    labels = rng.integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    labels[1, 5:20] = -100
    want = float(jax.jit(lambda t, h, lab: JL.chunked_ce_loss(t, h, lab, jcfg))(
        jnp.asarray(table), jnp.asarray(hidden), jnp.asarray(labels)))
    got = L.chunked_ce_loss(torch.from_numpy(table), torch.from_numpy(hidden),
                            torch.from_numpy(labels), tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= LOSS_ATOL, (float(got), want)
    none = L.chunked_ce_loss(torch.from_numpy(table), torch.from_numpy(hidden),
                             torch.full((2, 48), -100, dtype=torch.int32), tcfg)
    assert float(none) == 0.0
    with pytest.raises(ValueError):
        L.chunked_ce_loss(torch.from_numpy(table), torch.from_numpy(hidden[:, :40]),
                          torch.from_numpy(labels[:, :40]), tcfg)


@pytest.mark.parametrize("arch", ["qwen15_05b", "arctic_480b"])
def test_loss_fn_is_ce_plus_aux(arch):
    """loss_fn = chunked CE of the final hidden states + the MoE aux loss
    (arctic's, above 0), and its value equals the reference's."""
    jcfg, tcfg = P.cfgs(arch, "f32")
    params = P.perturb(JS.init_params(JM.model_schema(jcfg), P.KEY))
    tp = P.carry(params)
    jb = next(jax_batches(jcfg, 2, 16, seed=3))
    tb = next(batches(tcfg, 2, 16, seed=3, device="cpu"))
    with torch.no_grad():
        loss = M.loss_fn(tp, tb, tcfg)
        hidden, aux = M.forward(tp, tb, tcfg)
        ce = L.chunked_ce_loss(M._unembed_table(tp, tcfg), hidden, tb["labels"], tcfg)
    assert torch.equal(loss, ce + aux)
    assert (float(aux) > 0) == bool(tcfg.moe)
    want = jax.jit(lambda p, b: JM.loss_fn(p, b, jcfg))(params, jb)
    assert abs(float(loss) - float(want)) <= LOSS_ATOL


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


class _CountMM(TorchDispatchMode):
    """Counts the ``aten.mm`` calls dispatched while installed."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _loss_and_grads(params, batch, cfg):
    items = [(p, t.detach().requires_grad_()) for p, t in tree_items(params)]
    from repro_torch.models.schema import tree_from_items

    with _CountMM() as count:
        loss = M.loss_fn(tree_from_items(items), batch, cfg)
        grads = torch.autograd.grad(loss, [t for _, t in items], allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), grads, count.mm


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "zamba2_7b"])
def test_remat_is_bitwise_and_dots_recompute_fewer_products(arch):
    """remat "full" and "dots" give the loss and every gradient bitwise
    remat=False's (DeepSeek's leading dense and MoE stacks, zamba2's nested
    groups and tail); "full" recomputes every block's products in the
    backward pass, "dots" keeps theirs: it runs no more ``aten.mm`` than
    remat=False (whose only recompute is the CE chunks' unembedding)."""
    _, cfg = P.cfgs(arch, "f32")
    jcfg, _ = P.cfgs(arch, "f32")
    params = P.carry(P.perturb(JS.init_params(JM.model_schema(jcfg), P.KEY)))
    batch = next(batches(cfg, 2, 16, seed=4, device="cpu"))
    base, base_g, base_mm = _loss_and_grads(params, batch, cfg)
    mms = {}
    for policy in ("full", "dots"):
        loss, grads, mms[policy] = _loss_and_grads(
            params, batch, dataclasses.replace(cfg, remat=True, remat_policy=policy))
        assert torch.equal(loss, base), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, base_g)), policy
    assert base_mm == mms["dots"] < mms["full"], (base_mm, mms)


def test_remat_off_without_gradients(monkeypatch):
    """Under no_grad (serving) a remat config runs the blocks as they are:
    no checkpoint is taken and the forward is bitwise remat=False's; with
    gradients recorded each block is checkpointed."""
    jcfg, cfg = P.cfgs("qwen15_05b", "f32")
    params = P.carry(JS.init_params(JM.model_schema(jcfg), P.KEY))
    batch = next(batches(cfg, 2, 16, seed=4, device="cpu"))
    calls = []
    orig = M.checkpoint
    monkeypatch.setattr(M, "checkpoint", lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        a, _ = M.forward(params, batch, dataclasses.replace(cfg, remat=True))
    b, _ = M.forward(params, batch, cfg)
    assert torch.equal(a, b) and calls == []
    with torch.enable_grad():
        M.forward(params, batch, dataclasses.replace(cfg, remat=True))
    assert len(calls) == cfg.num_layers


def test_trainable_language_model_reaches_its_parameters():
    """A LanguageModel's tree() hands out the parameters: after
    requires_grad_(True) the loss of it has their gradients, equal to the
    functional path's; as built for serving it records no graph."""
    jcfg, cfg = P.cfgs("qwen15_05b", "f32")
    tp = P.carry(JS.init_params(JM.model_schema(jcfg), P.KEY))
    batch = next(batches(cfg, 2, 16, seed=4, device="cpu"))
    lm = M.LanguageModel(cfg, tp).requires_grad_(True)
    loss = M.loss_fn(lm.tree(), batch, cfg)
    loss.backward()
    _, want, _ = _loss_and_grads(tp, batch, cfg)
    got = [p.grad for _, p in tree_items(lm.tree())]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    frozen = M.LanguageModel(cfg, tp)
    assert not M.loss_fn(frozen.tree(), batch, cfg).requires_grad


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_matches_manual_math():
    opt = O.OptConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      grad_clip=0.0)
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([0.5, -0.5])}
    state = O.init_opt_state(params, opt)
    new_p, new_s, gnorm = O.adamw_update(params, grads, state, opt)
    m = 0.1 * np.array([0.5, -0.5])
    v = 0.001 * np.array([0.25, 0.25])
    mh = m / (1 - 0.9)
    vh = v / (1 - 0.999)
    lr = 0.1 * min(1.0, 1 / 100)  # warmup step 1/100
    want = np.array([1.0, 2.0]) - lr * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert float(gnorm) == pytest.approx(np.sqrt(0.5), rel=1e-5)
    assert new_s["step"].dtype == torch.int32 and int(new_s["step"]) == 1


def test_grad_clip_caps_update():
    opt = O.OptConfig(lr=1.0, grad_clip=0.001, warmup_steps=1)
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 100.0)}
    state = O.init_opt_state(params, opt)
    _, _, gnorm = O.adamw_update(params, grads, state, opt)
    assert float(gnorm) == pytest.approx(200.0)


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
def test_adamw_steps_match_reference(moment_dtype):
    """Five steps on a tree of fp32 and bf16 leaves with seeded gradients of
    growing size: the warmup (3 steps), the clip (from step 3), the weight
    decay, bf16 moments; parameters, moments, step and grad norm against
    the reference's at every step."""
    jdt, tdt = P.DTYPES[moment_dtype]
    jopt = JO.OptConfig(lr=0.01, warmup_steps=3, grad_clip=1.0, moment_dtype=jdt)
    topt = O.OptConfig(lr=0.01, warmup_steps=3, grad_clip=1.0, moment_dtype=tdt)
    shapes = {"b": {"w": (4, 3), "z": (5,)}, "a": (7,)}
    rng = np.random.default_rng(9)
    jp = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32), shapes,
                      is_leaf=lambda s: isinstance(s, tuple))
    jp["b"]["z"] = jp["b"]["z"].astype(jnp.bfloat16)
    tp = P.carry(jp)
    js, ts = JO.init_opt_state(jp, jopt), O.init_opt_state(tp, topt)
    for step in range(5):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.3 * (step + 1),
                                               p.dtype), jp)
        jp, js, jn = JO.adamw_update(jp, g, js, jopt)
        tp, ts, tn = O.adamw_update(tp, P.carry(g), ts, topt)
        assert float(tn) == pytest.approx(float(jn), rel=OPT_RTOL)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            gf, wf = _flat(got), _flat(want)
            assert gf.keys() == wf.keys()
            for k in wf:
                np.testing.assert_allclose(gf[k], wf[k], rtol=OPT_RTOL, atol=1e-9,
                                           err_msg=f"step {step + 1} {k}")
    assert tp["b"]["z"].dtype == torch.bfloat16 and ts["m"]["a"].dtype == tdt


# ---------------------------------------------------------------------------
# the train step and loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_reference(accum):
    """One step (gradient accumulation over 4 microbatches or none) from the
    reference's parameters and batch: loss, grad norm, step and every
    updated parameter and moment; the port's parameters are updated in
    place."""
    jcfg, tcfg = _tiny()
    jopt, topt = JO.OptConfig(lr=1e-3, grad_clip=0.0), O.OptConfig(lr=1e-3, grad_clip=0.0)
    params = JS.init_params(JM.model_schema(jcfg), P.KEY)
    jb = next(jax_batches(jcfg, 8, 16, seed=1))
    tb = next(batches(tcfg, 8, 16, seed=1, device="cpu"))
    js = {"params": params, "opt": JO.init_opt_state(params, jopt)}
    ts = TL.make_train_step(tcfg, topt, accum)
    tp = P.carry(params)
    state = {"params": tp, "opt": O.init_opt_state(tp, topt)}
    leaf = tp["blocks"]["attn"]["wq"]
    s2, m2 = ts(state, tb)
    s1, m1 = jax.jit(JTL.make_train_step(jcfg, jopt, accum_steps=accum))(js, jb)
    assert s2["params"]["blocks"]["attn"]["wq"] is leaf  # updated in place
    assert all(isinstance(v, torch.Tensor) for v in m2.values())
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), abs=LOSS_ATOL)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-4)
    assert int(m2["step"]) == int(m1["step"]) == 1
    for got, want in ((s2["params"], s1["params"]), (s2["opt"]["m"], s1["opt"]["m"])):
        gf, wf = _flat(got), _flat(want)
        for k in wf:
            np.testing.assert_allclose(gf[k], wf[k], rtol=0, atol=STEP_ATOL, err_msg=k)


def test_grad_accumulation_equivalence():
    """The reference's test on the port: 4 microbatches give the step of
    the whole batch."""
    _, cfg = _tiny()
    opt = O.OptConfig(lr=1e-3, grad_clip=0.0)
    batch = next(batches(cfg, 8, 16, seed=1, device="cpu"))
    out = []
    for accum in (1, 4):
        state = TL.init_train_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
        out.append(TL.make_train_step(cfg, opt, accum)(state, batch))
    (s1, m1), (s2, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for (_, a), (_, b) in zip(tree_items(s1["params"]), tree_items(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=5e-5)


def test_loss_decreases_tiny_train():
    _, cfg = _tiny()
    opt = O.OptConfig(lr=3e-3, warmup_steps=2)
    data = batches(cfg, 4, 32, seed=0, device="cpu")
    state, hist = TL.train_loop(cfg, opt, data, steps=20, log_every=1, device="cpu")
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(math.isfinite(x) for x in losses)
    assert [int(h["step"]) for h in hist] == list(range(1, 21))
    assert int(state["opt"]["step"]) == 20


def test_train_state_init_and_abstract():
    """init_train_state draws the schema's parameters with zero moments and
    step 0; abstract_train_state has the same shapes and dtypes on the meta
    device (bf16 moments when asked)."""
    _, cfg = _tiny()
    opt = O.OptConfig(moment_dtype=torch.bfloat16)
    state = TL.init_train_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    abst = TL.abstract_train_state(cfg, opt)
    got, want = list(tree_items(state)), list(tree_items(abst))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and b.device.type == "meta"
    assert all(float(m.abs().sum()) == 0 for _, m in tree_items(state["opt"]["m"]))
    assert state["opt"]["m"]["embed"]["table"].dtype == torch.bfloat16
    assert state["opt"]["step"].dtype == torch.int32 and int(state["opt"]["step"]) == 0
