"""Helpers shared by the LM family parity tests (``test_torch_moe.py``,
``test_torch_mla.py``, ``test_torch_ssm.py``, ``test_torch_hybrid.py``):
the reference's and the port's configs side by side, the reference's
parameters carried across with their fp32-read leaves perturbed, the
tolerance, and the routing spies that let a whole MoE model be compared
where its routing agrees.

Tolerance: 2e-4 absolute in fp32 (the reference's decode bound), and
``BF16_BOUND`` x max(1, max |reference|) in bf16 (the attention families'
bound, ``test_torch_decode.py``).  One exception, measured: in bf16 a whole
model without MoE holds each quantity (the forward's hidden states, the
decode logits over all steps, each cache) to the larger of that bound and
``NOISE_FLOOR`` times the largest error of the reference's own bf16 run
against its fp32 run on that quantity.  Each block adds about one bf16 ulp
of difference (the products sum in another order), so at zamba2's depth (7
SSD blocks and 2 shared attention blocks at the smoke size) two correct
bf16 runs differ by as much as either differs from the exact answer: the
port's bf16 hidden states differ from the reference's by 0.023 of their
scale, its decode logits by 0.0206, its attention cache by 0.098 (scale
3.86), while the reference's bf16 run differs from its own fp32 run by
0.0226, 0.0195 and 0.089 (ratios up to 1.14 over zamba2's and mamba2's
quantities; the port's bf16 run is as close to the fp32 answer as the
reference's).  An MoE model's fp32 run would route differently, so MoE
models hold 0.02 everywhere.

Routing: the top k of a router's probabilities is a discontinuous function
of its input, so two correct implementations whose hidden states differ in
the last bits can route a token differently where two probabilities are
nearly equal.  A whole MoE model is therefore compared token by token
where both sides route the token to the same experts and keep the same
assignments at every MoE layer; every flip must sit where the reference's
gap between its k-th and (k+1)-th probability is below ``FLIP_GAP`` (in
fp32 1e-6; in bf16 1e-3, against measured flips at gaps of 3.9e-5 and
2.6e-4 in smoke DeepSeek's bf16 decode), and most tokens must be compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import moe as MOE
from repro_torch.models import schema as S

KEY = jax.random.PRNGKey(1)
F32_BOUND = 2e-4
BF16_BOUND = 0.02
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FLIP_GAP = {"f32": 1e-6, "bf16": 1e-3}
NOISE_FLOOR = 1.5
#: the leaves whose init (ones or zeros) would hide a wrong cast or a
#: missing term: every norm scale, MLA's kv_norm, the SSM's gated norm,
#: decay, skip, step bias and conv bias, and the attention biases
PERTURBED = frozenset({"scale", "kv_norm", "norm", "A_log", "D", "dt_bias", "conv_b",
                       "bq", "bk", "bv"})


def cfgs(arch, dtype, moe=None, **kw):
    """(reference, port) smoke configs of ``arch`` at compute ``dtype``,
    with ``moe`` fields and other fields replaced."""
    jdt, tdt = DTYPES[dtype]
    ref = dataclasses.replace(jax_smoke_config(jax_get_config(arch)), compute_dtype=jdt, **kw)
    got = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=tdt, **kw)
    if moe:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe))
        got = dataclasses.replace(got, moe=dataclasses.replace(got.moe, **moe))
    return ref, got


def perturb(params, seed: int = 0):
    """The reference's tree with every ``PERTURBED`` leaf moved off its
    init by seeded noise (0.1 standard deviations), in its own dtype."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key not in PERTURBED:
            return a
        noise = rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return (jnp.asarray(a, jnp.float32) + noise).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, params)


def carry(params) -> dict:
    return S.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bound(ref, dtype: str) -> float:
    ref = np_(ref)
    if dtype == "f32":
        return F32_BOUND
    return BF16_BOUND * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)


def close(got, ref, dtype: str, where=None, floor: float = 0.0) -> float:
    """Max |got - ref| (over ``where``, a boolean mask of the leading axes,
    when given), asserted within the dtype's bound of the same values, or
    within ``floor`` where that is larger."""
    got, ref = np_(got), np_(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if where is not None:
        got, ref = got[where], ref[where]
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= max(bound(ref, dtype), floor), (err, bound(ref, dtype), floor)
    return err


def randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# routing spies
# ---------------------------------------------------------------------------


class Routing:
    """Records each router call on both sides while installed: the
    reference's probabilities and top-k indices (``jax.lax.top_k``, seen
    concretely when the reference runs eagerly, ``scan_layers=False``) and
    the port's indices (``moe.route``)."""

    def __init__(self, monkeypatch):
        self.ref, self.got = [], []
        top_k, route = jax.lax.top_k, MOE.route

        def ref_spy(x, k):
            out = top_k(x, k)
            self.ref.append((np.asarray(x), np.asarray(out[1])))
            return out

        def got_spy(params, xg, cfg):
            out = route(params, xg, cfg)
            self.got.append(out[2].cpu().numpy())
            return out

        monkeypatch.setattr(jax.lax, "top_k", ref_spy)
        monkeypatch.setattr(MOE, "route", got_spy)

    def clean(self, cfg, dtype: str) -> list[np.ndarray]:
        """Per router call (in call order), a flat boolean per token (group
        major) that is True where both sides chose the same experts and kept
        the same assignments; asserts each flip is at a small reference
        gap."""
        assert len(self.ref) == len(self.got) > 0
        m = cfg.moe
        out = []
        for (probs, ridx), gidx in zip(self.ref, self.got):
            g, gs, _ = probs.shape
            cap = max(1, int(np.ceil(gs * m.top_k * m.capacity_factor / m.num_experts)))
            same = (np.sort(ridx, -1) == np.sort(gidx, -1)).all(-1)
            top = -np.sort(-probs, -1)
            gap = top[..., m.top_k - 1] - top[..., m.top_k]
            assert (gap[~same] < FLIP_GAP[dtype]).all(), gap[~same]
            same &= (_kept(ridx, m.num_experts, cap) == _kept(gidx, m.num_experts, cap)).all(-1)
            out.append(same.reshape(-1))
        return out


def _kept(idx: np.ndarray, e: int, cap: int) -> np.ndarray:
    """[g, t, e]: the experts that keep each token's assignment (a token
    picks an expert at most once, so the reference's token-major, then-k
    priority counts each expert's slots in token order)."""
    oh = (idx[..., None] == np.arange(e)).any(-2)
    pos = np.cumsum(oh, axis=1) - oh
    return oh & (pos < cap)


def forward_mask(clean: list[np.ndarray], b: int, s: int) -> np.ndarray:
    """[B, S]: the positions of a forward that no routing difference
    reaches: those before the first token of their sequence that differs
    at any layer (attention carries a difference to later positions)."""
    ok = np.logical_and.reduce([c.reshape(b, s) for c in clean])
    return np.cumprod(ok, axis=1).astype(bool)


def decode_mask(clean: list[np.ndarray], steps: int, b: int) -> np.ndarray:
    """[steps, B]: the lanes of each decode step that no routing difference
    reached at that step or before (a lane's cache carries it on)."""
    per = np.asarray(clean).reshape(steps, -1, b).all(1)
    return np.cumprod(per, axis=0).astype(bool)


# ---------------------------------------------------------------------------
# a whole model against the reference
# ---------------------------------------------------------------------------


def tokens(cfg, b: int, t: int, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def model_parity(arch, dtype, monkeypatch, *, b=2, s=8, steps=8, moe=None, **kw) -> dict:
    """``forward`` (hidden states and the aux loss), ``logits_last`` and
    ``steps`` of ``decode_step`` (logits every step, every cache after the
    last) against the reference's, its parameters perturbed and carried
    across.  An MoE model runs the reference eagerly with routing spies and
    is compared where its routing agrees (at least half of the positions
    and of the lane-steps).  Returns the shares compared."""
    from repro.models import decode as JD
    from repro.models import model as JM
    from repro.models import schema as JS
    from repro_torch.models import decode as D
    from repro_torch.models import model as M

    jcfg, tcfg = cfgs(arch, dtype, moe=moe, **kw)
    routing = None
    if tcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, scan_layers=False)
        routing = Routing(monkeypatch)
    params = perturb(JS.init_params(JM.model_schema(jcfg), KEY))
    tp = carry(params)
    toks = tokens(jcfg, b, max(s, steps))

    jb, tb = {"tokens": jnp.asarray(toks[:, :s])}, {"tokens": torch.from_numpy(toks[:, :s])}
    ref_h, ref_aux = JM.forward(params, jb, jcfg)
    got_h, got_aux = M.forward(tp, tb, tcfg)
    assert got_h.dtype == tcfg.compute_dtype and got_aux.dtype == torch.float32
    mask = np.ones((b, s), bool)
    if routing is not None:
        mask = forward_mask(routing.clean(jcfg, dtype), b, s)
        routing.ref.clear(), routing.got.clear()
        if mask.all():
            assert abs(float(got_aux) - float(ref_aux)) <= 1e-3 * abs(float(ref_aux))
        assert float(got_aux) > 0
    else:
        assert float(got_aux) == float(ref_aux) == 0.0
    floor = 0.0
    if dtype == "bf16" and routing is None:
        exact, _ = JM.forward(params, jb, dataclasses.replace(jcfg, compute_dtype=jnp.float32))
        floor = NOISE_FLOOR * float(np.abs(np_(ref_h) - np_(exact)).max())
    close(got_h, ref_h, dtype, where=mask, floor=floor)
    ref_last = JM.logits_last(params, jb, jcfg)
    got_last = M.logits_last(tp, tb, tcfg)
    assert got_last.dtype == torch.float32 and got_last.shape == (b, jcfg.padded_vocab)
    close(got_last, ref_last, dtype, where=mask[:, -1])
    if routing is not None:
        routing.ref.clear(), routing.got.clear()

    def jstep(cfg):
        fn = lambda p, c, bt: JD.decode_step(p, c, bt, cfg)  # noqa: E731
        return fn if routing is not None else jax.jit(fn)

    step, exact_step = jstep(jcfg), jstep(dataclasses.replace(jcfg, compute_dtype=jnp.float32))
    jc, tc = JD.init_cache(jcfg, b, steps), D.init_cache(tcfg, b, steps, "cpu")
    xc = None if floor == 0.0 else JD.init_cache(
        dataclasses.replace(jcfg, compute_dtype=jnp.float32), b, steps)
    ref_logits, got_logits, noise = [], [], 0.0
    for i in range(steps):
        bt = {"tokens": jnp.asarray(toks[:, i:i + 1]), "pos": jnp.asarray(i, jnp.int32)}
        jl, jc = step(params, jc, bt)
        tl, tc = D.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, i:i + 1]),
                                        "pos": i}, tcfg)
        assert tl.dtype == torch.float32
        ref_logits.append(np_(jl)), got_logits.append(np_(tl))
        if xc is not None:
            xl, xc = exact_step(params, xc, bt)
            noise = max(noise, float(np.abs(np_(jl) - np_(xl)).max()))
    lanes = np.ones((steps, b), bool)
    if routing is not None:
        lanes = decode_mask(routing.clean(jcfg, dtype), steps, b)
    for i in range(steps):
        close(got_logits[i], ref_logits[i], dtype, where=lanes[i], floor=NOISE_FLOOR * noise)
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == getattr(torch, jnp.dtype(jc[k].dtype).name), k
        if routing is None:
            close(tc[k], jc[k], dtype, floor=0.0 if xc is None else
                  NOISE_FLOOR * float(np.abs(np_(jc[k]) - np_(xc[k])).max()))
        else:  # the lane axis of an attention-family cache is axis 1
            close(np.moveaxis(np_(tc[k]), 1, 0), np.moveaxis(np_(jc[k]), 1, 0), dtype,
                  where=lanes[-1])
    shares = dict(positions=float(mask.mean()), lane_steps=float(lanes.mean()))
    assert shares["positions"] >= 0.5 and shares["lane_steps"] >= 0.5, shares
    return shares
