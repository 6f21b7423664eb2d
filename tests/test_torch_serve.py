"""The port's serving engine (``repro_torch.serve.engine``) against the JAX
reference (``repro.serve.engine``, ``use_pallas=False``) tick by tick on the
scenarios of ``tests/test_engine.py``, those scenarios' properties on the
port, and the port's serving launcher (``repro_torch.launch.serve``), with
and without ``--real-decode``, and its example."""

import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve as jax_serve
from repro.serve import engine as jax_engine
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import engine

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch_serve_cluster.py"


def _engine(mod, **kw):
    kw.setdefault("num_frontends", 4)
    kw.setdefault("num_pods", 4)
    kw.setdefault("slots_per_pod", 16)
    kw.setdefault("max_batch", 64)
    if mod is jax_engine:
        kw["use_pallas"] = False
    else:
        kw["device"] = "cpu"
    return mod.MeghaServeEngine(**kw)


def _drain(eng, max_ticks=100_000):
    for _ in range(max_ticks):
        eng.tick()
        yield
        if not eng.running and all(not q for q in eng.queues):
            return


def _merge_queues(eng):
    eng.queues[0].extend(eng.queues[1])
    eng.queues[1].clear()


# Each scenario builds an engine of ``mod`` and yields it after every tick.
def _all_requests_complete(mod):
    eng = _engine(mod)
    rng = np.random.default_rng(0)
    eng.submit([mod.Request(i, gen_len=int(rng.integers(1, 20))) for i in range(300)])
    for _ in _drain(eng):
        yield eng


def _no_double_booking(mod):
    eng = _engine(mod, slots_per_pod=8)
    eng.submit([mod.Request(i, gen_len=50) for i in range(100)])
    for _ in range(30):
        eng.tick()
        yield eng


def _borrowed_slots_dark(mod):
    eng = _engine(mod, num_frontends=2, num_pods=2, slots_per_pod=4, heartbeat_ticks=1000)
    eng.submit([mod.Request(i, gen_len=2) for i in range(8)])
    _merge_queues(eng)
    for _ in range(10):
        eng.tick()
        yield eng


def _heartbeat_restores(mod):
    eng = _engine(mod, num_frontends=2, num_pods=2, slots_per_pod=4, heartbeat_ticks=2)
    eng.submit([mod.Request(i, gen_len=2) for i in range(8)])
    _merge_queues(eng)
    for _ in _drain(eng, 200):
        yield eng
    for _ in range(eng.pods):
        eng.tick()
        yield eng


def _overload(mod):
    eng = _engine(mod, num_pods=1, num_frontends=2, slots_per_pod=8)
    eng.submit([mod.Request(i, gen_len=5) for i in range(64)])
    for _ in _drain(eng):
        yield eng


SCENARIOS = {
    "all_requests_complete": _all_requests_complete,
    "no_double_booking": _no_double_booking,
    "borrowed_slots_dark": _borrowed_slots_dark,
    "heartbeat_restores": _heartbeat_restores,
    "overload": _overload,
}


def _snapshot(eng) -> dict:
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    s = eng.stats
    return dict(
        truth=arr(eng.truth),
        views=np.stack([arr(v) for v in eng.views]),
        running=sorted((slot, r.rid, r.frontend, r.start_tick, r.gen_len)
                       for slot, r in eng.running.items()),
        remaining=eng.remaining.copy(),
        queues=[[r.rid for r in q] for q in eng.queues],
        stats=(s.placed, s.completed, s.inconsistencies, s.repartitions, s.ticks,
               list(s.queue_delays)),
    )


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_reference_tick_by_tick(name):
    ticks = 0
    port_eng = ref_eng = None
    for port_eng, ref_eng in zip(SCENARIOS[name](engine), SCENARIOS[name](jax_engine),
                                 strict=True):
        a, b = _snapshot(port_eng), _snapshot(ref_eng)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, ticks)
            else:
                assert a[k] == b[k], (k, ticks)
        ticks += 1
    assert ticks > 0
    assert port_eng.stats.summary() == ref_eng.stats.summary()


def test_reference_engine_run_counts():
    """The reference's run of ``test_all_requests_complete`` (4 x 4 x 16
    slots, 300 requests, seed 0), which the worker-0 scatter quirk feeds
    into: the port gives the same counts."""
    *_, eng = _all_requests_complete(engine)
    s = eng.stats.summary()
    assert (s["inconsistencies"], s["repartitions"], s["ticks"]) == (355, 184, 65)
    assert eng.gm_rounds > 0


# ---------------------------------------------------------------------------
# the scenarios' properties (tests/test_engine.py) on the port
# ---------------------------------------------------------------------------


def test_all_requests_complete():
    *_, eng = _all_requests_complete(engine)
    assert eng.stats.completed == eng.stats.placed == 300
    assert int(eng.truth.sum()) == eng.w  # all slots free again


def test_no_double_booking():
    for eng in _no_double_booking(engine):
        slots = list(eng.running.keys())
        assert len(slots) == len(set(slots))
        assert eng.w - int(eng.truth.sum()) == len(slots)


def test_borrowed_slots_dark_until_heartbeat():
    *_, eng = _borrowed_slots_dark(engine)
    assert eng.stats.repartitions > 0
    free_truth = int(eng.truth.sum())
    assert int(eng.views[0].sum()) == free_truth - eng.stats.repartitions


def test_heartbeat_restores_visibility():
    *_, eng = _heartbeat_restores(engine)
    assert eng.stats.completed == 8
    for v in eng.views:
        assert int(v.sum()) == eng.w


def test_overload_queues_then_drains():
    eng = _engine(engine, num_pods=1, num_frontends=2, slots_per_pod=8)
    eng.submit([engine.Request(i, gen_len=5) for i in range(64)])
    eng.tick()
    assert len(eng.running) == 8
    stats = eng.run_until_drained()
    assert stats.completed == 64
    assert stats.summary()["p95_queue_delay"] > 0


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_matches_reference_engine_loop(capsys):
    """``launch/serve.py``'s loop (Poisson arrivals and lengths from the
    numpy seed) gives the reference engine's stats under the same loop."""
    got = launch_serve.main(["--requests", "120", "--device", "cpu", "--seed", "3"])
    rng = np.random.default_rng(3)
    eng = jax_engine.MeghaServeEngine(num_frontends=2, num_pods=2, slots_per_pod=16,
                                      max_batch=32, use_pallas=False)
    rid = 0
    while rid < 120:
        n = min(int(rng.poisson(8.0)), 120 - rid)
        eng.submit([jax_engine.Request(rid + i, gen_len=1 + int(rng.poisson(12)))
                    for i in range(n)])
        rid += n
        eng.tick()
    assert got == eng.run_until_drained().summary()
    assert got["completed"] == 120
    assert "requests=120/120" in capsys.readouterr().out


def test_serve_launcher_refuses_what_is_not_ported(monkeypatch):
    """Nothing runs on the CPU unless asked: with no card, the engine and
    the runner raise without ``--device cpu``, for every family."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.MeghaServeEngine()
    for arch in ("qwen15_05b", "deepseek_v2_lite_16b", "arctic_480b", "mamba2_13b",
                 "zamba2_7b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve.ModelRunner(arch, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "mamba2_13b", "--real-decode", "--requests", "8"])


def _summary_lines(out: str) -> list[str]:
    """The launcher's printed lines without the wall clock and device."""
    lines = out.strip().splitlines()
    return [lines[0].split(" wall=")[0]] + lines[1:]


@pytest.mark.parametrize("argv", [
    ["--real-decode"],
    ["--real-decode", "--arch", "llama3_8b", "--requests", "60", "--slots", "8", "--seed", "2"],
])
def test_serve_launcher_real_decode_matches_reference(argv, capsys, monkeypatch):
    """``--real-decode`` runs one pod's lanes on the smoke model: the port's
    launcher prints the reference launcher's summary and ``real decode:``
    lines."""
    got = launch_serve.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    ref_out = capsys.readouterr().out
    assert _summary_lines(port_out) == _summary_lines(ref_out)
    assert "real decode: " in port_out.splitlines()[-1]
    requests = int(argv[argv.index("--requests") + 1]) if "--requests" in argv else 200
    assert got["completed"] == requests


@pytest.mark.parametrize("arch", ["arctic_480b", "deepseek_v2_lite_16b", "mamba2_13b",
                                  "zamba2_7b"])
def test_serve_launcher_real_decode_later_families(arch, capsys, monkeypatch):
    """``--real-decode`` for the MoE, MLA, SSM and hybrid families on the
    CPU: the reference launcher's lines, every request completed, and the
    runner's last logits finite."""
    argv = ["--real-decode", "--arch", arch, "--requests", "40", "--slots", "8", "--seed", "1"]
    runners = []
    init = launch_serve.ModelRunner.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        runners.append(self)

    monkeypatch.setattr(launch_serve.ModelRunner, "__init__", keep)
    got = launch_serve.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    ref_out = capsys.readouterr().out
    assert _summary_lines(port_out) == _summary_lines(ref_out)
    assert port_out.splitlines()[-1].endswith(f"on 8 lanes ({arch} smoke config)")
    assert got["completed"] == 40
    (runner,) = runners
    assert runner.pos > 0 and bool(torch.isfinite(runner.logits).all())


def test_torch_serve_cluster_example(capsys, monkeypatch):
    """``examples/torch_serve_cluster.py`` with its defaults on the CPU:
    the reference example's lines."""
    monkeypatch.setattr(sys, "argv", [str(EXAMPLE), "--device", "cpu"])
    runpy.run_path(str(EXAMPLE), run_name="__main__")
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [str(EXAMPLE.with_name("serve_cluster.py"))])
    runpy.run_path(str(EXAMPLE.with_name("serve_cluster.py")), run_name="__main__")
    ref_out = capsys.readouterr().out
    assert _summary_lines(port_out) == _summary_lines(ref_out)
    assert port_out.splitlines()[-1] == (
        "real decode: 16 tokens/lane on 16 lanes (qwen15_05b smoke config)")
