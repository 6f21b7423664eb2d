"""The port's data pipeline (``repro_torch.data.pipeline``), checkpoints
(``repro_torch.train.checkpoint``) and training launcher
(``repro_torch.launch.train``, ``examples/torch_train_100m.py``) on the
CPU, against the reference's where one exists: batches bitwise, checkpoints
restored across the two packages bitwise, the launcher's printed lines.
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as JP
from repro.launch import train as JLT
from repro.train import checkpoint as JC
from repro.train import loop as JTL
from repro.train import optimizer as JO
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.data import pipeline as TP
from repro_torch.launch import train as LT
from repro_torch.models.schema import tree_items
from repro_torch.train import checkpoint as C
from repro_torch.train import loop as TL
from repro_torch.train import optimizer as O

ROOT = P.__file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch work on one intra-op thread: the tiny models'
    ops are small, and under parallel test workers extra threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    cfg = smoke_config(get_config("qwen15_05b"))
    return dataclasses.replace(cfg, vocab_size=128, loss_chunk=16)


def _bits(x) -> np.ndarray:
    """An array's raw bytes as unsigned integers of its width (bitwise
    comparison, bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [
    ("qwen15_05b", "f32"), ("hubert_xlarge", "bf16"), ("llava_next_mistral_7b", "bf16"),
    ("llava_next_mistral_7b", "f32")])
def test_batches_bitwise(arch, dtype):
    """Token, frame (hubert) and patch (llava) frontends: three steps of a
    host's slice, every array bitwise the reference's, in its dtype."""
    jdt, tdt = P.DTYPES[dtype]
    jcfg = dataclasses.replace(jax_smoke_config(jax_get_config(arch)), compute_dtype=jdt)
    tcfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype=tdt)
    ref = JP.batches(jcfg, 8, 32, seed=3, host_index=1, host_count=2)
    got = TP.batches(tcfg, 8, 32, seed=3, host_index=1, host_count=2, device="cpu")
    for _ in range(3):
        rb, gb = next(ref), next(got)
        assert rb.keys() == gb.keys()
        for k in rb:
            assert str(gb[k].dtype) == f"torch.{jnp.dtype(rb[k].dtype).name}", k
            assert gb[k].shape == rb[k].shape and gb[k].device.type == "cpu"
            np.testing.assert_array_equal(_bits(gb[k]), _bits(np.asarray(rb[k])), err_msg=k)


def test_markov_tokens_bitwise_and_host_split():
    for vocab in (7, 503, 151_936):
        a = JP._markov_tokens(np.random.default_rng(1), 3, 40, vocab)
        b = TP._markov_tokens(np.random.default_rng(1), 3, 40, vocab)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    with pytest.raises(ValueError):
        next(TP.batches(_tiny(), 6, 16, host_count=4, device="cpu"))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    cfg = _tiny()
    opt = O.OptConfig()
    state = TL.init_train_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    C.save(tmp_path, state, step=7)
    assert C.latest_step(tmp_path) == 7
    restored = C.restore(tmp_path, 7, like=state, device="cpu")
    assert [p for p, _ in tree_items(restored)] == [p for p, _ in tree_items(state)]
    for (_, a), (_, b) in zip(tree_items(state), tree_items(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["leaves"][0]["path"] == "opt/m/blocks/attn/bk"
    assert {"path": "opt/step", "shape": [], "dtype": "int32"} in manifest["leaves"]
    plain = C.restore(tmp_path, 7, device="cpu")  # no template: the manifest's paths
    assert torch.equal(plain["params"]["embed"]["table"], state["params"]["embed"]["table"])


def test_checkpoint_restart_resumes(tmp_path):
    """Kill-and-restart fault tolerance: the second run continues from the
    published checkpoint, not from scratch."""
    cfg = _tiny()
    opt = O.OptConfig(lr=1e-3)
    data = lambda: TP.batches(cfg, 4, 16, seed=2, device="cpu")  # noqa: E731
    state1, _ = TL.train_loop(cfg, opt, data(), steps=6, checkpoint_dir=str(tmp_path),
                              checkpoint_every=3, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST", "step_3", "step_6"]
    six = C.restore(tmp_path, 6, like=state1, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(six), tree_items(state1)))
    state2, hist = TL.train_loop(cfg, opt, data(), steps=10, checkpoint_dir=str(tmp_path),
                                 checkpoint_every=5, log_every=1, device="cpu")
    assert int(state2["opt"]["step"]) == 10 - 6 + int(state1["opt"]["step"])
    assert [int(h["step"]) for h in hist] == [7, 8, 9, 10]
    assert C.latest_step(tmp_path) == 10


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    state = {"w": torch.ones(4)}
    C.save(tmp_path, state, step=1)
    with pytest.raises(ValueError, match="shape mismatch at w"):
        C.restore(tmp_path, 1, like={"w": torch.ones(5)}, device="cpu")
    with pytest.raises(ValueError, match="checkpoint has 1 leaves, template has 2"):
        C.restore(tmp_path, 1, like={"w": torch.ones(4), "x": torch.ones(1)}, device="cpu")


def _mixed_state(seed: int = 0) -> dict:
    """A reference train state of the tiny config with one bf16 leaf."""
    cfg = dataclasses.replace(jax_smoke_config(jax_get_config("qwen15_05b")), vocab_size=128)
    state = JTL.init_train_state(cfg, JO.OptConfig(), jax.random.PRNGKey(seed))
    table = state["params"]["embed"]["table"]
    state["params"]["embed"]["table"] = table.astype(jnp.bfloat16)
    return state


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    """A checkpoint the reference wrote (fp32 leaves, an int32 step and a
    bf16 leaf, which numpy reads back as ``|V2``) restores in the port
    bitwise, in the reference's leaf order, with and without a template."""
    state = _mixed_state()
    JC.save(tmp_path, state, step=3)
    like = P.carry(state)
    for got in (C.restore(tmp_path, 3, like=like, device="cpu"),
                C.restore(tmp_path, 3, device="cpu")):
        want = {"/".join(str(k.key) for k in p): v
                for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}
        items = list(tree_items(got))
        assert ["/".join(p) for p, _ in items] == list(want)
        for path, leaf in items:
            ref = np.asarray(want["/".join(path)])
            assert str(leaf.dtype) == f"torch.{ref.dtype.name}"
            np.testing.assert_array_equal(_bits(leaf), _bits(ref), err_msg="/".join(path))


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    """A checkpoint the port wrote restores in the reference: every leaf
    bitwise, the bf16 leaf as its 2-byte bit pattern (the reference's
    restore keeps the payload's dtype, and jax cannot hold numpy's
    ``|V2`` reading of its own bf16 payload either), and the manifest is
    the reference's for the same state."""
    state = _mixed_state(1)
    C.save(tmp_path / "port", P.carry(state), step=4)
    JC.save(tmp_path / "ref", state, step=4)
    manifest = [json.loads((tmp_path / d / "step_4" / "manifest.json").read_text())
                for d in ("port", "ref")]
    assert manifest[0] == manifest[1]
    got = JC.restore(tmp_path / "port", 4)
    want = {"/".join(str(k.key) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}
    flat = {"/".join(str(k.key) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert list(flat) == list(want)
    for k in want:
        np.testing.assert_array_equal(_bits(np.asarray(flat[k])), _bits(np.asarray(want[k])),
                                      err_msg=k)
    assert np.asarray(flat["params/embed/table"]).dtype == np.uint16


def test_bf16_checkpoint_needs_no_ml_dtypes(tmp_path, monkeypatch):
    """With ``ml_dtypes`` unimportable a bf16 leaf saves and restores."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    leaf = torch.randn(3, 5, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    C.save(tmp_path, {"w": leaf}, step=1)
    back = C.restore(tmp_path, 1, device="cpu")["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16),
                                                        leaf.view(torch.int16))


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------


def test_scaled_config_matches_reference():
    for arch in list_archs():
        for preset in ("tiny", "100m", "full"):
            want = JLT.scaled_config(jax_get_config(arch), preset)
            got = LT.scaled_config(get_config(arch), preset)
            for f in ("num_layers", "d_model", "d_ff", "vocab_size", "loss_chunk", "num_heads",
                      "num_kv_heads", "head_dim", "attn_every"):
                assert getattr(got, f) == getattr(want, f), (arch, preset, f)
            for sub in ("moe", "mla", "ssm"):
                assert (getattr(got, sub) is None) == (getattr(want, sub) is None)
                if getattr(want, sub) is not None:
                    assert dataclasses.asdict(getattr(got, sub)) == dataclasses.asdict(
                        getattr(want, sub))
    with pytest.raises(ValueError):
        LT.scaled_config(get_config("qwen15_05b"), "1b")


def test_launcher_tiny_preset_end_to_end(tmp_path, capsys):
    """``python -m repro_torch.launch.train --preset tiny --device cpu``:
    the reference's printed lines, a checkpoint every 5 steps, the loss
    falling."""
    hist = LT.main(["--arch", "qwen15_05b", "--preset", "tiny", "--steps", "10", "--batch",
                    "4", "--seq", "32", "--lr", "3e-3", "--ckpt-dir", str(tmp_path),
                    "--ckpt-every", "5", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen15_05b preset=tiny params=")
    assert out[0].endswith("batch=4 seq=32")
    assert [line.split()[:2] for line in out[1:11]] == [["step", str(i)] for i in range(1, 11)]
    assert out[11].startswith("done: 10 steps, 1280 tokens, ")
    assert out[12].endswith("(improved)") and hist[-1]["loss"] < hist[0]["loss"]
    assert C.latest_step(tmp_path) == 10 and (tmp_path / "step_5").is_dir()


def test_example_runs_with_its_defaults(tmp_path, monkeypatch, capsys):
    """``examples/torch_train_100m.py --device cpu`` (its checkpoint
    directory moved under the test's)."""
    monkeypatch.setattr(sys, "argv", ["torch_train_100m.py", "--device", "cpu", "--steps", "4",
                                      "--ckpt-dir", str(tmp_path)])
    runpy.run_path(f"{ROOT}/examples/torch_train_100m.py", run_name="__main__")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=llama3_8b preset=tiny") and out[0].endswith("batch=4 seq=64")
    assert out[-2].startswith("done: 4 steps, 1024 tokens")
    assert C.latest_step(tmp_path) == 4


def test_launcher_resumes_and_has_nothing_to_do_after_the_last_step(tmp_path, capsys):
    """A rerun resumes from the checkpoint and counts only the steps it
    ran; once the last step is saved a rerun says so and trains nothing."""
    args = ["--arch", "qwen15_05b", "--preset", "tiny", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    LT.main(args + ["--steps", "2"])
    capsys.readouterr()
    hist = LT.main(args + ["--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert [int(h["step"]) for h in hist] == [3]
    assert out[-2].startswith("done: 1 steps, 32 tokens, ")
    assert LT.main(args + ["--steps", "3"]) == []
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen15_05b preset=tiny")
    assert out[1:] == [f"nothing to do: the checkpoint in {tmp_path} is at step 3 of --steps 3"]
    assert C.latest_step(tmp_path) == 3


def test_example_keeps_its_checkpoints_in_the_checkout():
    """The example's default checkpoint directory is the checkout's
    ``_build/`` (ignored by git), not a path shared with other checkouts or
    with the reference's example."""
    ns = runpy.run_path(f"{ROOT}/examples/torch_train_100m.py")
    root = Path(ROOT).resolve()
    assert ns["CKPT_DIR"] == root / "_build" / "torch_train_example"
    assert ns["DEFAULTS"][ns["DEFAULTS"].index("--ckpt-dir") + 1] == str(ns["CKPT_DIR"])
    assert "/_build/" in (root / ".gitignore").read_text().splitlines()
