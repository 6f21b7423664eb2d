"""The port's distribution specs (``repro_torch.dist.sharding``,
``models.schema.ShardingRules`` / ``param_pspecs`` / ``P``,
``decode.input_specs``, ``loop.train_state_pspecs``, ``layers.constrain``
and ``launch.mesh``) against the reference's on the CPU.

The specs read only a mesh's axis names and sizes, so the reference runs on
a stand-in mesh object at the production sizes (its own (16, 16) and
(2, 16, 16), and the port's H100 layout (32, 8) and (2, 32, 8)); specs
compare as tuples, exactly.  The reference's resident-bytes helper runs on
a real (1, 1) jax mesh.
"""

import dataclasses
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.dist import sharding as JSH
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import schema as JS
from repro.train import loop as JTL
from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs, smoke_config
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.schema import P, ShardingRules, _leaf_paths, tree_items
from repro_torch.train import loop as TL

#: (shape, axis names) of the four production meshes the specs are held at
MESHES = {
    "ref_single": ((16, 16), ("data", "model")),
    "ref_multi": ((2, 16, 16), ("pod", "data", "model")),
    "h100_single": ((32, 8), ("data", "model")),
    "h100_multi": ((2, 32, 8), ("pod", "data", "model")),
}
ARCHS = list_archs()


def _meshes(name):
    """(the reference's stand-in mesh, the port's Mesh) of one shape."""
    shape, names = MESHES[name]
    stand_in = types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=np.int8))
    return stand_in, MESH.Mesh(shape, names)


def _flat(tree, prefix=()):
    """(path, spec as a tuple) of every spec leaf of a nested dict, sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), tuple(v)))
    return out


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_sharding_rules_equal_the_reference(mesh, fsdp):
    jm, tm = _meshes(mesh)
    ref, got = JSH.sharding_rules(jm, fsdp=fsdp), SH.sharding_rules(tm, fsdp=fsdp)
    assert got.rules == ref.rules
    assert got.mesh_axis_sizes == ref.mesh_axis_sizes == MESH.mesh_axis_sizes(tm)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_and_spec_for_every_leaf(arch, mesh):
    """``ShardingRules.resolve`` of every (dim, axis) and ``spec_for`` of
    every parameter leaf, FSDP on and off."""
    jm, tm = _meshes(mesh)
    jsch = dict(JS._leaf_paths(JM.model_schema(jax_get_config(arch))))
    for fsdp in (False, True):
        jr, tr = JSH.sharding_rules(jm, fsdp=fsdp), SH.sharding_rules(tm, fsdp=fsdp)
        for path, pd in _leaf_paths(M.model_schema(get_config(arch))):
            jpd = jsch[path]
            assert pd.shape == jpd.shape and pd.axes == jpd.axes
            for d, a in zip(pd.shape, pd.axes):
                assert tr.resolve(d, a) == jr.resolve(d, a), (path, d, a)
            assert tuple(tr.spec_for(pd)) == tuple(jr.spec_for(jpd)), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_and_train_state_pspecs_equal_the_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    for fsdp in (False, True):
        ref = JSH.model_pspecs(jax_get_config(arch), jm, fsdp=fsdp)
        got = SH.model_pspecs(get_config(arch), tm, fsdp=fsdp)
        assert _flat(got) == _flat(ref)
        ref = JTL.train_state_pspecs(jax_get_config(arch), jm, fsdp=fsdp)
        got = TL.train_state_pspecs(get_config(arch), tm, fsdp=fsdp)
        assert _flat(got) == _flat(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspecs_equal_the_reference(arch, mesh):
    """Every applicable shape's batch specs, and each decode shape's cache
    specs (the encoder-only arch has no cache)."""
    jm, tm = _meshes(mesh)
    jcells = {c.name: c for c in J_SHAPES}
    n = 0
    for cell, reason in applicable_shapes(get_config(arch)):
        if reason is not None:
            continue
        ref = JSH.batch_pspecs(jax_get_config(arch), jcells[cell.name], jm)
        assert _flat(SH.batch_pspecs(get_config(arch), cell, tm)) == _flat(ref)
        if cell.kind == "decode":
            ref = JSH.cache_pspecs(jax_get_config(arch), jm, cell.global_batch, cell.seq_len)
            got = SH.cache_pspecs(get_config(arch), tm, cell.global_batch, cell.seq_len)
            assert _flat(got) == _flat(ref)
            n += 1
    assert n >= (0 if get_config(arch).is_encoder_only else 1)


def test_cache_pspecs_at_an_indivisible_batch():
    """The divisibility guard: a batch of 3 replicates, as the reference's."""
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for arch in ("llama3_8b", "mamba2_13b", "zamba2_7b", "deepseek_v2_lite_16b"):
            ref = JSH.cache_pspecs(jax_get_config(arch), jm, 3, 64)
            assert _flat(SH.cache_pspecs(get_config(arch), tm, 3, 64)) == _flat(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references_shapes_and_dtypes(arch):
    jcells = {c.name: c for c in J_SHAPES}
    for cell in SHAPES:
        ref = JD.input_specs(jax_get_config(arch), jcells[cell.name])
        got = D.input_specs(get_config(arch), cell)
        assert sorted(got) == sorted(ref)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), (cell.name, k)
            assert _dtype_name(t.dtype) == _dtype_name(ref[k].dtype), (cell.name, k)


def test_decode_pos_is_a_0d_int32():
    got = D.input_specs(get_config("qwen15_05b"), SHAPES[2])["pos"]
    assert got.dim() == 0 and got.dtype == torch.int32


def test_p_is_a_tuple_with_the_references_entries():
    spec = P(("pod", "data"), None, "model")
    assert isinstance(spec, tuple) and len(spec) == 3
    assert tuple(spec) == tuple(jax.sharding.PartitionSpec(("pod", "data"), None, "model"))
    assert tuple(P()) == ()
    assert tuple(P(("data",), None)) == tuple(jax.sharding.PartitionSpec(("data",), None))
    import copy
    import pickle

    assert pickle.loads(pickle.dumps(spec)) == spec and copy.deepcopy(spec) == spec
    assert type(pickle.loads(pickle.dumps(spec))) is P


def test_divisibility_fallback_and_one_axis_per_spec():
    """The reference's own cases (``tests/test_schema_sharding.py``) on the
    port, at (16, 16) and at the H100 (32, 8)."""
    from repro_torch.models.schema import ParamDef

    for sizes in ({"data": 16, "model": 16}, {"data": 32, "model": 8}):
        rules = {"vocab": "model", "heads": "model", "kv_heads": "model", "mlp": "model",
                 "experts": "model", "ssm_inner": "model", "embed": None, "head_dim": None,
                 "layers": None}
        r = ShardingRules(rules=rules, mesh_axis_sizes=sizes)
        # 56 heads (arctic) do not divide 16, 12 heads do not divide 8 -> replicated
        heads = 56 if sizes["model"] == 16 else 12
        assert r.spec_for(ParamDef((7168, heads, 128), ("embed", "heads", "head_dim"))) == \
            P(None, None, None)
        assert r.spec_for(ParamDef((4096, 32, 128), ("embed", "heads", "head_dim"))) == \
            P(None, "model", None)
        rf = ShardingRules(rules={**rules, "embed": "data"}, mesh_axis_sizes=sizes)
        pd = ParamDef((2, 128, 2048, 1408), ("layers", "experts", "embed", "mlp"))
        assert rf.spec_for(pd) == P(None, "model", "data", None)


def test_named_maps_specs_to_dtensor_placements():
    _, single = _meshes("h100_single")
    _, multi = _meshes("h100_multi")
    assert SH.named(single, P(None, "model", None)) == (Replicate(), Shard(1))
    assert SH.named(single, P("data", None)) == (Shard(0), Replicate())
    assert SH.named(multi, P(("pod", "data"), None, "model")) == (Shard(0), Shard(0), Shard(2))
    assert SH.named(multi, P()) == (Replicate(), Replicate(), Replicate())
    tree = SH.named(single, TL.train_state_pspecs(get_config("qwen15_05b"), single))
    assert tree["opt"]["step"] == (Replicate(), Replicate())
    assert tree["params"]["blocks"]["attn"]["wq"] == (Replicate(), Shard(2))


def test_local_shape_at_the_h100_mesh_by_hand():
    """Shard shapes at (32, 8) and (2, 32, 8), computed by hand."""
    _, single = _meshes("h100_single")
    _, multi = _meshes("h100_multi")
    qwen = get_config("qwen15_05b")
    wq = SH.model_pspecs(qwen, single)["blocks"]["attn"]["wq"]          # [24, 1024, 16, 64]
    assert SH.local_shape((24, 1024, 16, 64), SH.named(single, wq), single) == (24, 1024, 2, 64)
    wq = SH.model_pspecs(qwen, single, fsdp=True)["blocks"]["attn"]["wq"]
    assert SH.local_shape((24, 1024, 16, 64), SH.named(single, wq), single) == (24, 32, 2, 64)
    tok = SH.batch_pspecs(qwen, SHAPES[0], multi)["tokens"]             # [256, 4096]
    assert SH.local_shape((256, 4096), SH.named(multi, tok), multi) == (4, 4096)
    k = SH.cache_pspecs(qwen, multi, 128, 32768)["k"]                   # [24, 128, 32768, 16, 64]
    assert SH.local_shape((24, 128, 32768, 16, 64), SH.named(multi, k), multi) == \
        (24, 2, 32768, 2, 64)
    with pytest.raises(ValueError):
        SH.local_shape((3, 4), (Shard(0), Replicate()), single)


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module, imported with the backend already up
    (it sets ``XLA_FLAGS`` for 512 placeholder devices at import; the flag
    is put back so no later process sees it)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_bytes_equal_the_reference_on_a_1x1_mesh(arch, ref_dryrun):
    """``_resident_bytes`` of the train state and of the decode cache (the
    reference's ``NamedSharding.shard_shape``) on a (1, 1) mesh, and of the
    port alone at (32, 8): the state over 256 shards by hand."""
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro_torch.launch import dryrun as DR

    jmesh, tmesh = j_host_mesh(), MESH.make_host_mesh(device="cpu")
    assert MESH.mesh_axis_sizes(tmesh) == {"data": 1, "model": 1}
    jcfg, cfg = jax_smoke_config(jax_get_config(arch)), smoke_config(get_config(arch))
    jopt, opt = ref_dryrun._opt_for(jcfg), DR._opt_for(cfg)
    ref = ref_dryrun._resident_bytes(JTL.abstract_train_state(jcfg, jopt),
                                     JTL.train_state_pspecs(jcfg, jmesh), jmesh)
    got = DR._resident_bytes(TL.abstract_train_state(cfg, opt),
                             TL.train_state_pspecs(cfg, tmesh), tmesh)
    assert got == ref
    if not cfg.is_encoder_only:
        ref = ref_dryrun._resident_bytes(JD.cache_spec(jcfg, 4, 64),
                                         JSH.cache_pspecs(jcfg, jmesh, 4, 64), jmesh)
        got = DR._resident_bytes(D.init_cache(cfg, 4, 64, "meta"),
                                 SH.cache_pspecs(cfg, tmesh, 4, 64), tmesh)
        assert got == ref
    # at (32, 8) the specs' shards, leaf by leaf
    _, single = _meshes("h100_single")
    full = get_config(arch)
    specs = dict(tree_items(TL.train_state_pspecs(full, single, fsdp=True)))
    want = 0
    for path, t in tree_items(TL.abstract_train_state(full, DR._opt_for(full))):
        shape = list(t.shape)
        for d, part in enumerate(specs[path]):
            for a in (part if isinstance(part, tuple) else (part,) if part else ()):
                shape[d] //= {"data": 32, "model": 8}[a]
        want += math.prod(shape) * t.dtype.itemsize
    got = DR._resident_bytes(TL.abstract_train_state(full, DR._opt_for(full)),
                             TL.train_state_pspecs(full, single, fsdp=True), single)
    assert got == want


def test_host_mesh_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the host mesh counts it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MESH.make_host_mesh()
    assert MESH.make_host_mesh(4, device="cpu").shape == (1, 1)


def test_production_meshes_are_laid_out_for_h100_nodes():
    s, m = MESH.make_production_mesh(), MESH.make_production_mesh(multi_pod=True)
    assert MESH.mesh_axis_sizes(s) == {"data": 32, "model": 8} and s.size == 256
    assert MESH.mesh_axis_sizes(m) == {"pod": 2, "data": 32, "model": 8} and m.size == 512


# --------------------------------------------------------------------------
# constrain
# --------------------------------------------------------------------------

def test_constrain_returns_its_argument_without_a_mesh():
    x = torch.ones(2, 3)
    assert MESH.ambient is None
    assert L.constrain(x, "batch", None) is x
    with MESH.Mesh((1, 1), ("data", "model")) as m:
        assert MESH.ambient is m
        assert L.constrain(x, "batch", "model") is x
        with MESH.make_production_mesh(multi_pod=True):
            assert MESH.ambient.axis_names == ("pod", "data", "model")
        assert MESH.ambient is m
    assert MESH.ambient is None


@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data", "model"), ("x",)])
def test_constraint_spec_resolves_as_the_reference(names):
    """The reference's resolution inside a mesh of those axis names."""
    captured = []
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = lambda x, s: captured.append(tuple(s)) or x
    try:
        mesh = jax.make_mesh((1,) * len(names), names)
        with mesh:
            for axes in (("batch", None, None), ("batch", None, "model"), ("model",), ()):
                JL.constrain(jnp.zeros((1,) * len(axes)), *axes)
                assert tuple(L.constraint_spec(names, axes)) == captured[-1], axes
    finally:
        jax.lax.with_sharding_constraint = orig


def _capture_both(monkeypatch):
    ref, got = [], []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: ref.append(tuple(s)) or x)
    monkeypatch.setattr(L, "_place", lambda x, s: got.append(tuple(s)) or x)
    return ref, got


@pytest.mark.parametrize("arch", ["qwen15_05b", "deepseek_v2_lite_16b", "mamba2_13b",
                                  "zamba2_7b"])
def test_constrain_call_sites_hand_the_references_specs(arch, monkeypatch):
    """Inside a (1, 1) mesh, the loss of a smoke model (unrolled, one CE
    chunk: one reference trace per call) hands ``_place`` the specs, in
    order, that the reference hands ``with_sharding_constraint``; a decode
    step too (the MoE's one-hot constraint)."""
    jcfg = dataclasses.replace(jax_smoke_config(jax_get_config(arch)), scan_layers=False,
                               loss_chunk=16)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), loss_chunk=16)
    params = JS.init_params(JM.model_schema(jcfg), jax.random.PRNGKey(0))
    tparams = M.init_params(M.model_schema(cfg), torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    ref, got = _capture_both(monkeypatch)
    with jax.make_mesh((1, 1), ("data", "model")):
        JM.loss_fn(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}, jcfg)
    with MESH.Mesh((1, 1), ("data", "model")), torch.no_grad():
        t = torch.from_numpy(toks)
        M.loss_fn(tparams, {"tokens": t, "labels": t}, cfg)
    assert got == ref and len(ref) > 3
    if cfg.moe:
        n = len(ref)
        cache = JD.init_cache(jcfg, 2, 8) if hasattr(JD, "init_cache") else None
        if cache is None:
            cache = {k: jnp.zeros(s.shape, s.dtype) for k, s in JD.cache_spec(jcfg, 2, 8).items()}
        with jax.make_mesh((1, 1), ("data", "model")):
            JD.decode_step(params, cache, {"tokens": jnp.asarray(toks[:, :1]),
                                           "pos": jnp.int32(0)}, jcfg)
        with MESH.Mesh((1, 1), ("data", "model")), torch.no_grad():
            D.decode_step(tparams, D.init_cache(cfg, 2, 8, "cpu"),
                          {"tokens": torch.from_numpy(toks[:, :1]), "pos": 0}, cfg)
        assert got[n:] == ref[n:] and len(ref) > n
