"""The port's architecture configs (``repro_torch.configs``) against the
reference's (``repro.configs``): every arch's ``CONFIG``, ``smoke_config``
and ``applicable_shapes`` field by field (the ``jnp`` dtypes mapped to torch
dtypes), the derived properties, and ``param_counts`` (total and active) of
every full config."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as jax_model
from repro_torch import configs
from repro_torch.models import model

ARCHS = jax_configs.list_archs()
DTYPE_FIELDS = ("param_dtype", "compute_dtype", "cache_dtype")


def _as_torch(cfg) -> dict:
    """A reference config as a dict with its dtypes as torch dtypes and its
    nested configs as dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in DTYPE_FIELDS and v is not None:
            v = getattr(torch, jnp.dtype(v).name)
        elif dataclasses.is_dataclass(v):
            v = _as_torch(v)
        out[f.name] = v
    return out


def _fields(cfg) -> dict:
    return {f.name: _fields(getattr(cfg, f.name)) if dataclasses.is_dataclass(
        getattr(cfg, f.name)) else getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_arch_list_and_shape_cells():
    assert configs.list_archs() == ARCHS
    assert [dataclasses.astuple(c) for c in configs.SHAPES] == [
        dataclasses.astuple(c) for c in jax_configs.SHAPES]
    for name in ("ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShapeCell"):
        ref = [f.name for f in dataclasses.fields(getattr(jax_configs, name))]
        assert [f.name for f in dataclasses.fields(getattr(configs, name))] == ref, name


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_by_field(arch):
    ref, got = jax_configs.get_config(arch), configs.get_config(arch)
    assert _fields(got) == _as_torch(ref)
    assert isinstance(got.param_dtype, torch.dtype)
    assert isinstance(got.compute_dtype, torch.dtype)
    assert (got.padded_vocab, got.head_dim_eff, got.is_encoder_only) == (
        ref.padded_vocab, ref.head_dim_eff, ref.is_encoder_only)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches_reference(arch):
    ref = jax_configs.smoke_config(jax_configs.get_config(arch))
    got = configs.smoke_config(configs.get_config(arch))
    assert _fields(got) == _as_torch(ref)
    assert (got.padded_vocab, got.head_dim_eff) == (ref.padded_vocab, ref.head_dim_eff)


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_shapes_match_reference(arch):
    ref = jax_configs.applicable_shapes(jax_configs.get_config(arch))
    got = configs.applicable_shapes(configs.get_config(arch))
    assert [(dataclasses.astuple(c), r) for c, r in got] == [
        (dataclasses.astuple(c), r) for c, r in ref]


def test_get_config_names():
    assert configs.get_config("qwen15-05b") is configs.get_config("qwen15_05b")
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("gpt2")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_counts_match_reference(arch):
    """qwen 0.464 B, llama 8.03 B, gemma 8.54 B, stablelm 12.14 B, llava
    7.25 B, hubert 0.946 B, and the MoE, MLA, SSM and hybrid families'
    totals and active counts: the reference's counts exactly."""
    got = model.param_counts(configs.get_config(arch))
    assert got == jax_model.param_counts(jax_configs.get_config(arch))


def test_qwen_full_width_counts():
    total, active = model.param_counts(configs.get_config("qwen15_05b"))
    assert total == active and round(total / 1e9, 3) == 0.464
    assert configs.get_config("qwen15_05b").padded_vocab == 152_064


def test_moe_full_width_counts():
    """DeepSeek-V2-Lite: 15.7 B parameters, 2.66 B active (6 of 64 routed
    experts and the 2 shared); arctic: 477 B, 15.6 B active; the SSM and
    hybrid families have no unrouted parameters."""
    total, active = model.param_counts(configs.get_config("deepseek_v2_lite_16b"))
    assert (round(total / 1e9, 1), round(active / 1e9, 2)) == (15.7, 2.66)
    total, active = model.param_counts(configs.get_config("arctic_480b"))
    assert (round(total / 1e9), round(active / 1e9, 1)) == (477, 15.6)
    for arch in ("mamba2_13b", "zamba2_7b"):
        total, active = model.param_counts(configs.get_config(arch))
        assert total == active
