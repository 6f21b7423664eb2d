"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.hillclimb``)
on the CPU: the step traced on the meta device under ``FlopCounterMode``.

The reference's nine tiny cells (``tests/test_dryrun_plumbing.py``: three
archs x train / prefill / decode, smoke configs, ``loss_chunk`` 16) trace
on a (1, 1) mesh, and two of them equal a hand count of their products;
where the reference compiles a cell (qwen's and mamba2's decode) its
``cost_analysis`` FLOPs bound the port's count from above (XLA counts the
elementwise work too).  The u = 1 / u = 2 extrapolation equals the
full-depth trace for the dense, MoE, SSM and hybrid families.
"""

import dataclasses
import json
import os

import jax
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ShapeCell as JShapeCell
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hillclimb as HC
from repro_torch.launch.mesh import Mesh, mesh_axis_sizes

HOST = Mesh((1, 1), ("data", "model"))
CELLS = {
    "train": ShapeCell("train_tiny", "train", 64, 2),
    "prefill": ShapeCell("prefill_tiny", "prefill", 64, 2),
    "decode": ShapeCell("decode_tiny", "decode", 64, 2),
}
#: the result keys of the reference's run_cell that only XLA can fill
XLA_ONLY = {"xla_unfused_gbytes", "xla_memory_analysis_gb"}
REF_KEYS = {"arch", "shape", "mesh", "chips", "params_total", "params_active", "fsdp",
            "units", "roofline"} | XLA_ONLY


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


def _cfg(arch, **kw):
    return dataclasses.replace(smoke_config(get_config(arch)), loss_chunk=16, **kw)


@pytest.mark.parametrize("arch", ["qwen15_05b", "mamba2_13b", "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_trace_cell(arch, kind):
    """All nine tiny cells trace, the seven the reference's own compile
    fails on included."""
    counter, meta = DR.trace_cell(_cfg(arch), CELLS[kind], HOST, fsdp=False)
    assert counter.get_total_flops() > 0 and meta == {"fsdp": False}
    assert set(map(str, counter.get_flop_counts()["Global"])) <= {
        "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm"}


def test_qwen_smoke_decode_and_train_equal_a_hand_count():
    """qwen's smoke config (d 128, 2 layers, 4 heads of 32, 2 KV heads,
    gated d_ff 256, tied vocab 512; bias adds are no products)."""
    cfg = _cfg("qwen15_05b")
    d, hd, h, kv, f, v, nl = 128, 32, 4, 2, 256, 512, 2
    assert (cfg.d_model, cfg.head_dim_eff, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.padded_vocab, cfg.num_layers) == (d, hd, h, kv, f, v, nl)

    def layer(n, b, t_q, t_k):       # n tokens; b sequences of t_q queries over t_k keys
        proj = 2 * n * d * (h + 2 * kv) * hd + 2 * n * h * hd * d
        attn = 2 * (2 * b * h * t_q * t_k * hd)         # scores, probabilities x values
        return proj + attn + 3 * 2 * n * d * f

    dec = nl * layer(2, 2, 1, 64) + 2 * 2 * d * v
    counter, _ = DR.trace_cell(cfg, CELLS["decode"], HOST)
    assert counter.get_total_flops() == dec == 1_572_864
    fwd = nl * layer(128, 2, 64, 64) + 2 * 128 * d * v
    # backward: two products per product; the CE chunk's unembedding is
    # recomputed (it runs under a checkpoint; smoke configs run no remat)
    train = 3 * fwd + 2 * 128 * d * v
    counter, _ = DR.trace_cell(cfg, CELLS["train"], HOST)
    assert counter.get_total_flops() == train == 318_767_104


@pytest.mark.parametrize("arch", ["qwen15_05b", "mamba2_13b"])
def test_decode_count_is_at_most_the_references_cost_analysis(arch, ref_dryrun):
    """The two decode cells the reference compiles: XLA's ``flops`` (its
    layers unrolled, so every layer counts) is at least the port's count of
    the products."""
    jcfg = dataclasses.replace(jax_smoke_config(jax_get_config(arch)), loss_chunk=16,
                               scan_layers=False)
    lowered, _ = ref_dryrun.lower_cell(jcfg, JShapeCell("decode_tiny", "decode", 64, 2),
                                       jax.make_mesh((1, 1), ("data", "model")), fsdp=False)
    cost = lowered.compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    ref = float(cost["flops"])
    got = DR.trace_cell(_cfg(arch), CELLS["decode"], HOST)[0].get_total_flops()
    assert 0 < got <= ref, f"port {got} / reference {ref} = {got / ref:.4f}"


@pytest.mark.parametrize("arch", list_archs())
def test_unit_count_and_reduced_cfg_equal_the_reference(arch, ref_dryrun):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert DR.unit_count(cfg) == ref_dryrun.unit_count(jcfg)
    for cell in SHAPES:
        jcell = JShapeCell(cell.name, cell.kind, cell.seq_len, cell.global_batch)
        for u in (1, 2):
            got, ref = DR.reduced_cfg(cfg, u, cell), ref_dryrun.reduced_cfg(jcfg, u, jcell)
            assert (got.num_layers, got.loss_chunk, got.scan_layers) == \
                (ref.num_layers, ref.loss_chunk, ref.scan_layers)
    assert DR._use_fsdp(cfg) == ref_dryrun._use_fsdp(jcfg)
    assert DR.FSDP_PARAM_BYTES == ref_dryrun.FSDP_PARAM_BYTES
    assert str(DR._opt_for(cfg).moment_dtype).removeprefix("torch.") == \
        jax.numpy.dtype(ref_dryrun._opt_for(jcfg).moment_dtype).name


def test_the_references_own_unit_cases():
    z = get_config("zamba2_7b")
    assert DR.unit_count(z) == 13
    r = DR.reduced_cfg(z, 2, CELLS["train"])
    assert r.num_layers == 2 * 6 + 3 and r.scan_layers is False
    d = get_config("deepseek_v2_lite_16b")
    assert DR.unit_count(d) == 26 and DR.reduced_cfg(d, 1, CELLS["train"]).num_layers == 2
    assert DR.unit_count(get_config("qwen15_05b")) == 24


def test_extrapolate_equals_the_references(ref_dryrun):
    c1 = {"flops": 10.0, "bytes": 100.0, "coll_bytes": 5.0, "coll_counts": {"all-reduce": 2}}
    c2 = {"flops": 14.0, "bytes": 130.0, "coll_bytes": 8.0, "coll_counts": {"all-reduce": 3}}
    for units in (1, 2, 10, 81):
        assert DR._extrapolate(c1, c2, units) == ref_dryrun._extrapolate(c1, c2, units)
    out = DR._extrapolate(c1, c2, 10)
    assert out["flops"] == pytest.approx(10 + 4 * 9) and out["coll_counts"]["all-reduce"] == 11


@pytest.mark.parametrize("arch,layers", [("qwen15_05b", 5), ("deepseek_v2_lite_16b", 5),
                                         ("mamba2_13b", 5), ("zamba2_7b", 13)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolation_equals_the_full_depth_trace(arch, layers, kind):
    """The u = 1 / u = 2 traces extrapolated to the full depth equal the
    trace of the full depth: FLOPs, FLOPs by op, collectives by axis (on
    a (2, 2) mesh, so that every kind of collective is there)."""
    cfg = _cfg(arch, num_layers=layers, remat=True)
    cell = CELLS[kind]
    mesh = Mesh((2, 2), ("data", "model"))
    units = DR.unit_count(cfg)
    assert units >= 4
    c1 = DR._module_cost(DR.reduced_cfg(cfg, 1, cell), cell, mesh, False)
    c2 = DR._module_cost(DR.reduced_cfg(cfg, 2, cell), cell, mesh, False)
    full = DR._module_cost(cfg, cell, mesh, False)
    assert DR._extrapolate(c1, c2, units) == full
    assert full["flops"] > c2["flops"] > c1["flops"] > 0


def test_run_cell_writes_the_references_keys(tmp_path):
    res = DR.run_cell("qwen15_05b", "decode_32k", "single", out_dir=tmp_path, verbose=False)
    on_disk = json.loads((tmp_path / "qwen15_05b__decode_32k__single.json").read_text())
    assert on_disk == json.loads(json.dumps(res))
    assert REF_KEYS - XLA_ONLY <= set(res)
    assert set(res) - REF_KEYS == {"state_resident_gb", "activation_resident_gb", "flops_by_op",
                                   "collectives_by_axis", "link_gbps_by_axis"}
    roof = res["roofline"]
    from repro.roofline.analysis import Roofline

    assert set(roof) == set(Roofline.__dataclass_fields__)
    assert res["chips"] == 256 and res["units"] == 24 and res["fsdp"] is False
    for k in ("compute_s", "memory_s", "collective_s", "step_time_s"):
        assert roof[k] >= 0 and roof[k] == roof[k]
    assert roof["hlo_gflops"] > 0 and roof["bottleneck"] == "memory"
    assert roof["step_time_s"] == max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    assert res["link_gbps_by_axis"] == {"model": 450.0, "data": 50.0}


def test_run_cell_skips_with_the_references_reason(tmp_path):
    from repro.configs import applicable_shapes as j_applicable

    res = DR.run_cell("hubert_xlarge", "decode_32k", "multi", out_dir=tmp_path, verbose=False)
    ref = dict((c.name, r) for c, r in j_applicable(jax_get_config("hubert_xlarge")))
    assert res == {"arch": "hubert_xlarge", "shape": "decode_32k", "mesh": "multi",
                   "skipped": ref["decode_32k"]}
    assert (tmp_path / "hubert_xlarge__decode_32k__multi.json").exists()


def test_run_cell_on_a_given_config_cell_and_mesh():
    """What phase ``dryrun`` of the chip smoke does: the card's own cell
    (a smoke decode here) on a host mesh."""
    cfg = _cfg("qwen15_05b")
    res = DR.run_cell("qwen15_05b", "decode_tiny", "host", verbose=False, cfg=cfg,
                      cell=CELLS["decode"], mesh=HOST)
    assert res["chips"] == 1 and res["roofline"]["hlo_gflops"] * 1e9 == pytest.approx(1_572_864)
    assert res["roofline"]["collective_s"] == 0.0


def test_main_writes_a_file_per_cell(tmp_path, capsys):
    DR.main(["--arch", "qwen15_05b", "--shape", "decode_32k", "--mesh", "both",
             "--out", str(tmp_path)])
    assert "all dry-run cells passed" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen15_05b__decode_32k__multi.json", "qwen15_05b__decode_32k__single.json"]
    multi = json.loads((tmp_path / "qwen15_05b__decode_32k__multi.json").read_text())
    assert multi["chips"] == 512 and set(multi["collectives_by_axis"]) == {"pod", "data", "model"}


def test_hillclimb_measure_on_a_smoke_variant():
    cfg = _cfg("qwen15_05b")
    cell = CELLS["train"]
    row = HC.measure("smoke/qwen_train", cfg, cell, fsdp=False)
    assert {"tag", "arch", "shape", "flops_g", "coll_gb", "mem_gb", "compute_s", "memory_s",
            "collective_s", "step_s", "bottleneck", "useful", "model_flops_chip_g",
            "wall_s"} <= set(row)
    counter, _ = DR.trace_cell(cfg, cell, HOST)
    assert row["flops_g"] == pytest.approx(counter.get_total_flops() / 256 / 1e9)
    assert row["step_s"] == max(row["compute_s"], row["memory_s"], row["collective_s"])
    assert row["coll_gb"] > 0 and set(row["coll_gb_by_axis"]) == {"data", "model"}
    sizes = mesh_axis_sizes(HC.make_production_mesh())
    assert sizes == {"data": 32, "model": 8}


def test_hillclimb_constraint_variants_are_equal_in_the_port():
    """zamba2's SSM constraints change only GSPMD's placement: the port's
    terms are equal with and without them (smoke zamba2, train)."""
    cfg = _cfg("zamba2_7b")
    a = HC.measure("a", cfg, CELLS["train"], fsdp=False)
    b = HC.measure("b", dataclasses.replace(cfg, ssm_shard_constraints=False),
                   CELLS["train"], fsdp=False)
    for k in ("flops_g", "coll_gb", "mem_gb", "step_s"):
        assert a[k] == b[k]


def _chip_smoke():
    import importlib.util
    import pathlib
    import sys

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke"] = mod
    return sys.modules["chip_smoke"]


@pytest.mark.parametrize("arch", [a for a in list_archs() if get_config(a).causal])
def test_chip_smokes_step_ops_count_what_the_trace_counts(arch):
    """``chip_smoke._lm_step_ops`` (the decode step's operations bound)
    counts exactly the products ``FlopCounterMode`` counts over the step
    traced on the meta device: smoke configs at 4 lanes, and the five served
    models at full width (128 lanes against their caches)."""
    from repro_torch.models import decode as D

    cs = _chip_smoke()
    cases = [(smoke_config(get_config(arch)), 4, 32)]
    if arch in ("qwen15_05b", "deepseek_v2_lite_16b", "gemma_7b", "stablelm_12b",
                "llava_next_mistral_7b"):
        cases.append((get_config(arch), 128, 256 if arch == "qwen15_05b" else 128))
    for cfg, b, t in cases:
        counter, _ = DR.trace_cell(cfg, ShapeCell("d", "decode", t, b), HOST)
        bf16, fp32 = cs._lm_step_ops(cfg, b, D.cache_len(cfg, t))
        assert bf16 + fp32 == counter.get_total_flops(), (cfg.name, b)
