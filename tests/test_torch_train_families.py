"""The port's training loss and its gradients (``repro_torch.models.model.
loss_fn`` under ``torch.autograd``) against ``jax.value_and_grad`` of the
reference's ``loss_fn``, for every architecture's smoke config in fp32 and
bf16 compute, on the CPU, with the reference's parameters (their
fp32-read leaves perturbed) carried across and the same pipeline batch,
padded vocab and ``-100`` labels.

Tolerances, each gradient leaf against the same leaf of the reference:
- fp32 compute: the loss within 2e-5, each leaf within ``F32_REL`` x its
  largest reference entry, or ``BF16_GRAD_REL`` where the parameter (so
  the gradient) is bf16 (arctic's): measured up to 1.7e-6 of scale, 5.6e-6
  on zamba2's ``tail/ssm/A_log`` (a gradient of 7e-5), for fp32 leaves;
  3.2e-3 for bf16 ones (a bf16 rounding of the gradient).
- bf16 compute: the loss within ``torch_lm_parity.bound`` (0.02 x max(1,
  |loss|)); each leaf within ``BF16_REL`` x its largest reference entry:
  the products round to bf16 in another order, measured up to 0.054 of the
  leaf's scale (zamba2's shared attention, 7 SSD blocks deep).

MoE: the top k of the router's probabilities is discontinuous, so one
token routed to another expert on one side changes every gradient it
reaches.  The reference's routing is recorded from its compiled run
(``jax.debug.callback`` at each ``top_k``), the port's own top-k is
checked against it (a different choice only where the reference's gap
between its k-th and (k+1)-th probability is below
``torch_lm_parity.FLIP_GAP``), and the port then routes as the reference
does (its gates gathered from its own probabilities at those experts), so
that both sides' gradients are of one routing.  At these inputs no token
routes differently (arctic and deepseek, fp32 and bf16), so the port's
own routing is the one compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro.data.pipeline import batches as jax_batches
from repro.models import model as JM
from repro.models import schema as JS
from repro_torch.configs import list_archs
from repro_torch.data.pipeline import batches
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.schema import tree_from_items, tree_items

F32_LOSS = 2e-5
F32_REL = 5e-5
BF16_GRAD_REL = 0.01
BF16_REL = 0.1
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch work on one intra-op thread: the smoke models'
    ops are small, and under parallel test workers extra threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(jcfg, tcfg):
    """The pipeline's first batch on both sides (bitwise equal), with three
    labels of sequence 0 set to -100."""
    jb = next(jax_batches(jcfg, B, S, seed=0))
    tb = next(batches(tcfg, B, S, seed=0, device="cpu"))
    lab = np.asarray(jb["labels"]).copy()
    lab[0, :3] = -100
    return dict(jb, labels=jnp.asarray(lab)), dict(tb, labels=torch.from_numpy(lab))


def _ref_value_and_grad(params, batch, jcfg, monkeypatch):
    """``jax.value_and_grad(loss_fn)`` compiled, and (MoE) the router's
    probabilities and top-k indices of each MoE layer, in layer order."""
    routes = {}
    if jcfg.moe:
        top_k, n = jax.lax.top_k, [0]

        def spy(x, k):
            out = top_k(x, k)
            i = n[0]
            n[0] += 1
            jax.debug.callback(
                lambda xv, iv, i=i: routes.__setitem__(i, (np.asarray(xv), np.asarray(iv))),
                x, out[1])
            return out

        monkeypatch.setattr(jax.lax, "top_k", spy)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, b, jcfg)))(params, batch)
    if jcfg.moe:
        monkeypatch.setattr(jax.lax, "top_k", top_k)
    flat = {"/".join(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), flat, [routes[i] for i in sorted(routes)]


def _follow(routes, dtype: str, monkeypatch) -> list:
    """The port's ``moe.route`` routing as the reference did (call i of the
    port follows layer i of ``routes``); returns, per call, the tokens
    whose own top-k differed, each asserted to sit at a small reference
    gap."""
    route, calls = MOE.route, []

    def follow(params, xg, cfg):
        probs, _, idx = route(params, xg, cfg)
        ref_probs, ref_idx = routes[len(calls)]
        k = cfg.moe.top_k
        diff = (np.sort(idx.numpy(), -1) != np.sort(ref_idx, -1)).any(-1)
        top = -np.sort(-ref_probs, -1)
        gap = top[..., k - 1] - top[..., k]
        assert (gap[diff] < P.FLIP_GAP[dtype]).all(), gap[diff]
        calls.append(int(diff.sum()))
        idx = torch.tensor(ref_idx, dtype=idx.dtype)
        gate = torch.gather(probs, -1, idx)
        return probs, gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), idx

    monkeypatch.setattr(MOE, "route", follow)
    return calls


def port_value_and_grad(params: dict, batch: dict, cfg):
    """The port's loss and the gradient of every leaf (zeros for a leaf the
    loss does not read, as ``jax.grad`` gives)."""
    items = [(path, p.detach().requires_grad_()) for path, p in tree_items(params)]
    loss = M.loss_fn(tree_from_items(items), batch, cfg)
    grads = torch.autograd.grad(loss, [p for _, p in items], allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {"/".join(path): g for (path, _), g in zip(items, grads)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_reference(arch, dtype, monkeypatch):
    jcfg, tcfg = P.cfgs(arch, dtype)
    if jcfg.moe:  # one traced top_k per layer, for the routing record
        jcfg = dataclasses.replace(jcfg, scan_layers=False)
    params = P.perturb(JS.init_params(JM.model_schema(jcfg), P.KEY))
    jb, tb = _batch(jcfg, tcfg)
    ref_loss, ref_grads, routes = _ref_value_and_grad(params, jb, jcfg, monkeypatch)
    if jcfg.moe:
        flips = _follow(routes, dtype, monkeypatch)
    loss, grads = port_value_and_grad(P.carry(params), tb, tcfg)
    if jcfg.moe:
        assert len(flips) == len(routes) == tcfg.num_layers - tcfg.moe.first_k_dense
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    loss_bound = F32_LOSS if dtype == "f32" else P.bound(np.float32(ref_loss), "bf16")
    assert abs(float(loss) - ref_loss) <= loss_bound, (float(loss), ref_loss)
    assert grads.keys() == ref_grads.keys()
    for path, ref in ref_grads.items():
        got = grads[path]
        assert tuple(got.shape) == ref.shape and str(got.dtype) == f"torch.{ref.dtype.name}"
        rel = BF16_REL if dtype == "bf16" else (
            F32_REL if got.dtype == torch.float32 else BF16_GRAD_REL)
        ref = P.np_(jnp.asarray(ref))
        err = float(np.abs(P.np_(got) - ref).max())
        assert err <= rel * float(np.abs(ref).max()), (path, err, float(np.abs(ref).max()))
