"""The port's roofline (``repro_torch.roofline``: ``analysis``, ``traffic``,
``report``) against the reference's ``repro.roofline`` on the CPU.

``analytic_memory_bytes`` is held float for float to the reference's for
every arch x shape x mesh x FSDP; ``analyze`` and ``model_flops`` run the
reference's own cases (``tests/test_roofline.py``) with its TPU constants
passed in; ``analytic_collectives`` (the port's stand-in for the HLO parse)
is held to hand counts; ``report.table`` to the reference's string.
"""

import dataclasses
import math

import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.roofline import analysis as JR
from repro.roofline import report as JREP
from repro.roofline import traffic as JT
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.configs.base import ShapeCell
from repro_torch.models import model as M
from repro_torch.models.schema import _leaf_paths, param_bytes, param_count
from repro_torch.roofline import analysis as R
from repro_torch.roofline import report as REP
from repro_torch.roofline import traffic as T

#: the reference's TPU figures, passed in where its cases need them
V5E = dict(peak_flops=197e12, hbm_bw=819e9)
MESH_SIZES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
              {"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8}]


def test_analyze_terms_and_bottleneck():
    roof = R.analyze(
        arch="x", shape="train_4k", mesh_name="single", chips=256,
        cost={"flops": 197e12, "bytes accessed": 819e9 / 2},
        collectives={}, link_bw={}, model_flops_fleet=197e12 * 256 * 0.5,
        memory_per_device_bytes=8e9, **V5E,
    )
    assert roof.compute_s == pytest.approx(1.0)
    assert roof.memory_s == pytest.approx(0.5)
    assert roof.bottleneck == "compute"
    assert roof.useful_flops_ratio == pytest.approx(0.5)
    assert roof.roofline_fraction == pytest.approx(1.0)


def test_analyze_matches_the_reference_without_collectives():
    kw = dict(arch="x", shape="decode_32k", mesh_name="single", chips=256,
              cost={"flops": 3.2e12, "bytes accessed": 2.5e9},
              model_flops_fleet=1.1e15, memory_per_device_bytes=7e9)
    ref = JR.analyze(hlo_text="", **kw)
    got = R.analyze(collectives={}, link_bw={}, **kw, **V5E)
    assert got.to_json() == ref.to_json()
    assert R.Roofline.__dataclass_fields__.keys() == JR.Roofline.__dataclass_fields__.keys()


def test_collective_term_sums_bytes_over_each_axis_rate():
    sizes = {"data": 32, "model": 8}
    link = R.link_bandwidth(sizes)
    assert link == {"model": R.NVLINK_BW, "data": R.IB_BW}
    assert R.link_bandwidth({"data": 16, "model": 16}) == {"model": R.IB_BW, "data": R.IB_BW}
    assert R.link_bandwidth({"pod": 2, "data": 32, "model": 8}) == {
        "model": R.NVLINK_BW, "data": R.IB_BW, "pod": R.IB_BW}
    coll = {"model": R.CollectiveStats(), "data": R.CollectiveStats()}
    coll["model"].add("all-reduce", 900e9, 3)
    coll["data"].add("all-gather", 100e9, 2)
    roof = R.analyze(arch="x", shape="s", mesh_name="single", chips=256,
                     cost={"flops": 989e12, "bytes accessed": 0.0}, collectives=coll,
                     link_bw=link, model_flops_fleet=0.0, memory_per_device_bytes=0.0)
    assert roof.collective_s == pytest.approx(900e9 / 450e9 + 100e9 / 50e9)
    assert roof.collective_gbytes == pytest.approx(1000.0)
    assert roof.collective_counts == {"all-gather": 2, "all-reduce": 3, "reduce-scatter": 0,
                                      "all-to-all": 0, "collective-permute": 0}
    assert roof.bottleneck == "collective" and roof.compute_s == pytest.approx(1.0)
    assert roof.step_time_s == pytest.approx(4.0)


def test_h100_constants():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW, R.IB_BW) == (989e12, 3.35e12, 450e9, 50e9)


def test_model_flops_by_kind():
    cfg = get_config("llama3_8b")
    cells = {c.name: c for c in SHAPES}
    n = 8_000_000_000
    assert R.model_flops(cfg, cells["train_4k"], n, n) == pytest.approx(6 * n * 256 * 4096)
    assert R.model_flops(cfg, cells["prefill_32k"], n, n) == pytest.approx(2 * n * 32 * 32768)
    assert R.model_flops(cfg, cells["decode_32k"], n, n) == pytest.approx(2 * n * 128)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_and_param_counts_equal_the_reference(arch):
    from repro.models import model as JM

    total, active = M.param_counts(get_config(arch))
    assert (total, active) == JM.param_counts(jax_get_config(arch))
    for cell, jcell in zip(SHAPES, J_SHAPES):
        assert R.model_flops(get_config(arch), cell, total, active) == \
            JR.model_flops(jax_get_config(arch), jcell, total, active)


def _variants(arch):
    """(port cfg, reference cfg) pairs: the config, and for llama3_8b the
    hillclimb's bf16 weights and fp8 cache."""
    out = [(get_config(arch), jax_get_config(arch))]
    if arch == "llama3_8b":
        out.append((dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16,
                                        cache_dtype=torch.float8_e4m3fn),
                    dataclasses.replace(jax_get_config(arch), param_dtype=jnp.bfloat16,
                                        cache_dtype=jnp.float8_e4m3fn)))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_memory_bytes_equal_the_reference_float_for_float(arch):
    for cfg, jcfg in _variants(arch):
        for cell, jcell in zip(SHAPES, J_SHAPES):
            for sizes in MESH_SIZES:
                for fsdp in (False, True):
                    for mb in (2, 4):
                        got = T.analytic_memory_bytes(cfg, cell, sizes, fsdp=fsdp,
                                                      moment_bytes=mb)
                        ref = JT.analytic_memory_bytes(jcfg, jcell, sizes, fsdp=fsdp,
                                                       moment_bytes=mb)
                        assert got == ref, (cell.name, sizes, fsdp, mb)


def test_analytic_traffic_sane_ordering():
    """The reference's case: decode moves less than train; single-request
    MoE decode reads far less than its parameter bytes."""
    sizes = {"data": 16, "model": 16}
    cfg = get_config("llama3_8b")
    cells = {c.name: c for c in SHAPES}
    assert T.analytic_memory_bytes(cfg, cells["decode_32k"], sizes, fsdp=False) < \
        T.analytic_memory_bytes(cfg, cells["train_4k"], sizes, fsdp=True)
    moe = get_config("arctic_480b")
    one = ShapeCell("d1", "decode", 1024, 1)
    full = param_bytes(M.model_schema(moe)) / 16
    assert T.analytic_memory_bytes(moe, one, sizes, fsdp=False) < full / 10


# --------------------------------------------------------------------------
# analytic_collectives, by hand
# --------------------------------------------------------------------------

def _zeros_but(stats, **want):
    got = {k: (stats.counts[k], stats.bytes_by_kind[k]) for k in R.COLLECTIVES}
    exp = {k: want.get(k.replace("-", "_"), (0, 0)) for k in R.COLLECTIVES}
    assert got == exp


def test_collectives_dense_tensor_parallel_decode_with_the_vocab_sharded():
    """smoke qwen (d 128, 2 layers, 4 heads, d_ff 256, vocab 512, tied) on
    model = 2, decode of 4 lanes: each layer's attention and MLP split
    over "model" -> 2 all-reduces a layer of [4, 1, 128] bf16 (1,024 B);
    the vocab-sharded unembedding -> one all-gather of [4, 512] fp32."""
    cfg = smoke_config(get_config("qwen15_05b"))
    coll = T.analytic_collectives(cfg, ShapeCell("d", "decode", 64, 4),
                                  {"data": 1, "model": 2}, fsdp=False)
    _zeros_but(coll["model"], all_reduce=(4, 4 * 1024), all_gather=(1, 4 * 512 * 4))
    _zeros_but(coll["data"])


def test_collectives_train_adds_the_backward_and_the_remat_recompute():
    """The same model trained (B 8 over data 2: B_loc 4, S 16): 3 passes
    with remat "full", 2 without; the CE's statistics gathered twice; each
    parameter leaf's fp32 gradient all-reduced over "data"."""
    base = smoke_config(get_config("qwen15_05b"))
    cell = ShapeCell("t", "train", 16, 8)
    act = 4 * 16 * 128 * 2
    for remat, passes in ((True, 3), (False, 2)):
        cfg = dataclasses.replace(base, remat=remat, remat_policy="full")
        coll = T.analytic_collectives(cfg, cell, {"data": 2, "model": 2}, fsdp=False)
        _zeros_but(coll["model"], all_reduce=(4 * passes, 4 * passes * act),
                   all_gather=(2, 2 * 4 * 16 * 3 * 4 * 2))
        assert coll["data"].counts["all-reduce"] == len(list(_leaf_paths(M.model_schema(cfg))))
    dots = dataclasses.replace(base, remat=True, remat_policy="dots")
    coll = T.analytic_collectives(dots, cell, {"data": 2, "model": 2}, fsdp=False)
    assert coll["model"].counts["all-reduce"] == 4 * 2


def test_collectives_gradients_and_fsdp():
    """Data parallel alone (model = 1): without FSDP one all-reduce of each
    leaf's fp32 gradient, all the parameters' bytes x 4; with FSDP the
    leaves sharded over "data" (an "embed" axis) are gathered twice in
    their dtype and their gradients reduce-scattered, the rest all-reduced."""
    cfg = smoke_config(get_config("qwen15_05b"))
    cell = ShapeCell("t", "train", 16, 8)
    sch = M.model_schema(cfg)
    leaves = list(_leaf_paths(sch))
    coll = T.analytic_collectives(cfg, cell, {"data": 2, "model": 1}, fsdp=False)
    _zeros_but(coll["data"], all_reduce=(len(leaves), param_count(sch) * 4))
    _zeros_but(coll["model"])
    coll = T.analytic_collectives(cfg, cell, {"data": 2, "model": 1}, fsdp=True)
    fsdp = [pd for _, pd in leaves if "embed" in pd.axes]
    assert all(pd.shape[pd.axes.index("embed")] % 2 == 0 for pd in fsdp)
    n_fsdp, sharded = len(fsdp), sum(math.prod(pd.shape) for pd in fsdp)
    rest = param_count(sch) - sharded
    _zeros_but(coll["data"], all_gather=(2 * n_fsdp, 2 * sharded * 4),
               reduce_scatter=(n_fsdp, sharded * 4), all_reduce=(len(leaves) - n_fsdp, rest * 4))


def test_collectives_moe_expert_parallel():
    """smoke arctic (8 experts top 2, capacity 1.25, d 128, 2 MoE layers,
    a parallel dense MLP) on model = 2, train of 2 x 32 tokens without
    remat: 2 all-to-alls a layer and pass of 64 x 2 x 1.25 x 128 bf16
    (40,960 B); attention and the dense branch all-reduced."""
    cfg = smoke_config(get_config("arctic_480b"))
    assert not cfg.remat and cfg.moe.num_experts == 8 and cfg.num_layers == 2
    coll = T.analytic_collectives(cfg, ShapeCell("t", "train", 32, 2),
                                  {"data": 1, "model": 2}, fsdp=False)
    a2a = 64 * 2 * 1.25 * 128 * 2
    act = 2 * 32 * 128 * 2
    _zeros_but(coll["model"], all_to_all=(2 * 2 * 2, 2 * 2 * 2 * a2a),
               all_reduce=(2 * 2 * 2, 2 * 2 * 2 * act), all_gather=(2, 2 * 64 * 3 * 4 * 2))


def test_collectives_nothing_on_one_device():
    for arch in list_archs():
        for cell in SHAPES:
            coll = T.analytic_collectives(get_config(arch), cell, {"data": 1, "model": 1},
                                          fsdp=True)
            assert all(c.total_bytes == 0 for c in coll.values())


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

def _roof(compute, memory, coll, bottleneck):
    return {"compute_s": compute, "memory_s": memory, "collective_s": coll,
            "bottleneck": bottleneck, "model_gflops": 1234.5, "hlo_gflops": 2345.6,
            "useful_flops_ratio": 0.526, "memory_per_device_gb": 12.34}


def test_report_table_equals_the_reference():
    results = [
        {"arch": "qwen15_05b", "shape": "train_4k", "roofline": _roof(0.0215, 0.0046, 0.0261,
                                                                        "collective")},
        {"arch": "qwen15_05b", "shape": "long_500k", "skipped": "pure full-attention arch: "
         "500k KV cache is out of scope (per assignment)"},
        {"arch": "arctic_480b", "shape": "decode_32k", "error": "RuntimeError('x')"},
        {"arch": "zamba2_7b", "shape": "decode_32k", "roofline": _roof(1e-6, 1e-3, 0.0,
                                                                        "memory")},
    ]
    assert REP.table(results) == JREP.table(results)
    assert REP.ARCH_ORDER == JREP.ARCH_ORDER and REP.SHAPE_ORDER == JREP.SHAPE_ORDER


def test_report_load_reads_the_dry_runs_files(tmp_path):
    import json

    for r in ({"arch": "qwen15_05b", "shape": "decode_32k", "mesh": "single",
               "roofline": _roof(1.0, 2.0, 3.0, "collective")},
              {"arch": "hubert_xlarge", "shape": "decode_32k", "mesh": "single",
               "skipped": "encoder-only"}):
        (tmp_path / f"{r['arch']}__{r['shape']}__single.json").write_text(json.dumps(r))
    got = REP.load(str(tmp_path))
    assert [r["arch"] for r in got] == ["hubert_xlarge", "qwen15_05b"]
    assert got == JREP.load(str(tmp_path))
