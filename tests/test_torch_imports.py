"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
``jax`` and nothing of the reference package ``repro``."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: the port's examples (``examples/torch_*.py``) stand alone too
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


#: the LM stack's modules (configs, models and the serving runner)
LM_MODULES = ["repro_torch.configs", "repro_torch.configs.base", "repro_torch.models",
              "repro_torch.models.schema", "repro_torch.models.layers",
              "repro_torch.models.model", "repro_torch.models.decode",
              "repro_torch.launch.serve"] + [
    f"repro_torch.configs.{a}" for a in (
        "hubert_xlarge", "qwen15_05b", "gemma_7b", "llama3_8b", "stablelm_12b", "mamba2_13b",
        "llava_next_mistral_7b", "zamba2_7b", "arctic_480b", "deepseek_v2_lite_16b")]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_fresh_interpreter_imports_no_jax_or_repro():
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    s = importlib.util.spec_from_file_location(p.split('/')[-1][:-3], p)\n"
        "    sys.modules[s.name] = importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(sys.modules[s.name])\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "chip_smoke" in loaded and "repro_torch.sim.simulator" in loaded
    assert "repro_torch.analysis.speccheck" in loaded and "torch_quickstart" in loaded
    assert set(LM_MODULES) | {"torch_serve_cluster"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_chip_smoke_fails_without_a_card():
    """With no CUDA device visible the script exits non-zero and prints no
    result (in particular not the device line)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            bad += [
                a.value for a in node.args
                if isinstance(a, ast.Constant) and _forbidden(str(a.value))
            ]
    assert bad == []


def test_walk_covers_the_sweep_and_pigeon_modules():
    """The two checks above walk every module of the port; the batched
    sweep and the pigeon rule are among them."""
    assert {"repro_torch.simx.sweep", "repro_torch.simx.pigeon"} <= set(MODULES)
    assert {PORT / "simx" / "sweep.py", PORT / "simx" / "pigeon.py"} <= set(SOURCES)


def test_walk_covers_the_queue_rules_and_event_baselines():
    """The walk covers the sparrow and eagle rules, their fault helper and
    the event backend's copied baselines."""
    new = {"repro_torch.simx.sparrow", "repro_torch.simx.eagle", "repro_torch.simx.faults",
           "repro_torch.core.baselines", "repro_torch.core.baselines.sparrow",
           "repro_torch.core.baselines.eagle", "repro_torch.core.baselines.pigeon"}
    assert new <= set(MODULES)
    for rel in ("simx/sparrow.py", "simx/eagle.py", "simx/faults.py",
                "core/baselines/__init__.py", "core/baselines/sparrow.py",
                "core/baselines/eagle.py", "core/baselines/pigeon.py"):
        assert PORT / rel in SOURCES


def test_walk_covers_the_fault_modules():
    """The walk covers the fault subsystem and every module its slice
    touched: the schedules and plans, the runtime's fault stage, the five
    rules' fault branches, the engine, the Fig. 4 sweep and both
    backends' front door."""
    new = {"repro_torch.simx.faults", "repro_torch.simx.runtime", "repro_torch.simx.engine",
           "repro_torch.simx.sweep", "repro_torch.sim.simulator"} | {
        f"repro_torch.simx.{r}" for r in ("megha", "sparrow", "eagle", "pigeon", "oracle")}
    assert new <= set(MODULES)
    assert {PORT / (m.removeprefix("repro_torch.").replace(".", "/") + ".py")
            for m in new} <= set(SOURCES)


def test_walk_covers_the_telemetry_and_provenance_modules():
    """The walk covers the telemetry and provenance stages and the modules
    their slice touched: the runtime, the five rules' extras, the engine,
    the sweep's breakdown columns and the event backend's metrics."""
    new = {"repro_torch.simx.telemetry", "repro_torch.simx.provenance",
           "repro_torch.simx.runtime", "repro_torch.simx.engine", "repro_torch.simx.sweep",
           "repro_torch.core.metrics"} | {
        f"repro_torch.simx.{r}" for r in ("megha", "sparrow", "eagle", "pigeon", "oracle")}
    assert new <= set(MODULES)
    assert {PORT / (m.removeprefix("repro_torch.").replace(".", "/") + ".py")
            for m in new} <= set(SOURCES)


def test_walk_covers_the_stream_modules():
    """The walk covers the streaming engine, the P² kernel's wrapper and
    the arrival processes it streams."""
    new = {"repro_torch.simx.stream", "repro_torch.kernels.p2", "repro_torch.workload.synth"}
    assert new <= set(MODULES)
    assert {PORT / (m.removeprefix("repro_torch.").replace(".", "/") + ".py")
            for m in new} <= set(SOURCES)


def test_walk_covers_the_shard_module():
    """The walk covers the sharded executors and the modules their slice
    touched: the lane-batched stream segment, the P² lane axis and the
    rules' lane-stacked windows."""
    new = {"repro_torch.simx.shard", "repro_torch.simx.stream", "repro_torch.simx.telemetry",
           "repro_torch.kernels.p2", "repro_torch.simx.state"} | {
        f"repro_torch.simx.{r}" for r in ("megha", "sparrow", "eagle", "pigeon", "oracle")}
    assert new <= set(MODULES)
    assert {PORT / (m.removeprefix("repro_torch.").replace(".", "/") + ".py")
            for m in new} <= set(SOURCES)


def test_walk_covers_the_analysis_modules_and_examples():
    """The walk covers the static analysis (specs, linter, speccheck,
    sentinels), the trace files and the port's quickstart."""
    new = {f"repro_torch.analysis.{m}" for m in ("specs", "simxlint", "speccheck",
                                                 "sentinels")} | {
        "repro_torch.analysis", "repro_torch.workload.traces"}
    assert new <= set(MODULES)
    assert {PORT / (m.removeprefix("repro_torch.").replace(".", "/") + ".py")
            for m in new - {"repro_torch.analysis"}} <= set(SOURCES)
    assert ROOT / "examples" / "torch_quickstart.py" in SOURCES
    assert ROOT / "examples" / "quickstart.py" not in SOURCES


def test_walk_covers_the_lm_modules_and_serve_example():
    """The walk covers the LM stack's configs, models and serving runner,
    and the port's serving example."""
    assert set(LM_MODULES) <= set(MODULES)
    assert {PORT / (m.removeprefix("repro_torch.").replace(".", "/") + ".py")
            for m in LM_MODULES if m not in ("repro_torch.configs", "repro_torch.models")
            } <= set(SOURCES)
    assert ROOT / "examples" / "torch_serve_cluster.py" in SOURCES
    assert ROOT / "examples" / "serve_cluster.py" not in SOURCES


#: the training slice's modules (ROADMAP item 15d) and its example
TRAIN_MODULES = ["repro_torch.train", "repro_torch.train.optimizer", "repro_torch.train.loop",
                 "repro_torch.train.checkpoint", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.launch.train"]
TRAIN_SOURCES = [PORT / (m.removeprefix("repro_torch.").replace(".", "/") + ".py")
                 for m in TRAIN_MODULES if m not in ("repro_torch.train", "repro_torch.data")]
TRAIN_SOURCES += [PORT / "train" / "__init__.py", PORT / "data" / "__init__.py",
                  PORT / "models" / "layers.py", PORT / "models" / "model.py",
                  PORT / "models" / "schema.py", ROOT / "examples" / "torch_train_100m.py"]


def test_walk_covers_the_training_modules_and_example():
    """The two checks above walk the training modules, the data pipeline,
    the launcher and ``examples/torch_train_100m.py``."""
    assert set(TRAIN_MODULES) <= set(MODULES)
    assert set(TRAIN_SOURCES) <= set(SOURCES)
    assert ROOT / "examples" / "train_100m.py" not in SOURCES


def test_training_path_imports_no_ml_dtypes():
    """The training path (the modules, the example, a bf16 checkpoint saved
    and restored) loads neither ``jax``, ``repro`` nor ``ml_dtypes``, and no
    source of it names ``ml_dtypes`` outside ``schema.params_to_numpy``'s
    helper for the reference's trees."""
    code = (
        "import importlib, json, runpy, sys, tempfile, torch\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        f"for m in {TRAIN_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({str(ROOT / 'examples' / 'torch_train_100m.py')!r})\n"
        "from repro_torch.train import checkpoint as C\n"
        "d = tempfile.mkdtemp()\n"
        "C.save(d, {'w': torch.ones(3, dtype=torch.bfloat16)}, 1)\n"
        "assert C.restore(d, 1, device='cpu')['w'].dtype == torch.bfloat16\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(TRAIN_MODULES) <= set(loaded)
    assert [m for m in loaded if _forbidden(m) or m.split(".")[0] == "ml_dtypes"] == []
    for path in TRAIN_SOURCES:
        text = path.read_text()
        allowed = text.count("import ml_dtypes  # numpy's bfloat16") if path.name == "schema.py" else 0
        assert text.count("import ml_dtypes") == allowed, path


#: the distribution slice's modules (ROADMAP item 15e): the specs, the mesh,
#: the dry run, the hillclimb and the roofline
DIST_MODULES = ["repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.launch.mesh",
                "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
                "repro_torch.roofline", "repro_torch.roofline.analysis",
                "repro_torch.roofline.traffic", "repro_torch.roofline.report"]


def test_walk_covers_the_distribution_and_roofline_modules():
    """The two checks above walk ``dist/``, ``roofline/`` and the new
    ``launch/`` modules (and the model modules that gained ``constrain``)."""
    assert set(DIST_MODULES) <= set(MODULES)
    for sub in ("dist", "roofline"):
        assert set((PORT / sub).glob("*.py")) <= set(SOURCES)
    assert {PORT / "launch" / f"{m}.py" for m in ("mesh", "dryrun", "hillclimb")} <= set(SOURCES)
    assert {PORT / "models" / f"{m}.py" for m in ("layers", "moe", "ssm", "decode")} <= set(SOURCES)
