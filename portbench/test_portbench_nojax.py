"""No run loads JAX or the JAX package: names are compared whole, by the
part before the first dot, so the port ``repro_torch`` is not ``repro``."""

import subprocess
import sys
import textwrap

from portbench.cpu_cells import ROOT
from portbench.harness import forbidden_modules


def test_names_are_compared_whole():
    assert forbidden_modules({"repro_torch", "repro_torch.simx.sweep", "reprox"}) == []
    assert forbidden_modules({"repro", "repro.simx"}) == ["repro"]
    assert forbidden_modules({"jax.numpy", "jaxlib", "flax.linen", "torch"}) == [
        "flax", "jax", "jaxlib"]


SCRIPT = textwrap.dedent("""
    import sys, time, types
    sys.path[:0] = [{root!r}, {src!r}]
    import torch
    torch.set_num_threads(1)
    from portbench.cpu_cells import tiny
    from portbench import harness
    inject = {inject!r}
    if inject:
        sys.modules["repro"] = types.ModuleType("repro")
    t = time.perf_counter()
    code, result, out, err = harness.execute(tiny("sparrow"), 7, 0.0, False, "cpu",
                                             {{"start": t, "imports": t, "cuda_init": t}})
    print(code, result is None, harness.forbidden_modules(), err[-1])
""")


def _run(inject: bool) -> str:
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"), inject=inject)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_whole_run_loads_neither():
    code, no_result, found, _ = _run(False).split(" ", 3)
    assert (code, no_result, found) == ("0", "False", "[]")


def test_a_loaded_jax_package_stops_the_run():
    line = _run(True)
    assert line.startswith("3 True ['repro']"), line
