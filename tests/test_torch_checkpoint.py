"""The port's ``CheckpointManager`` against the reference's format: save,
``save_async``, restore and the garbage collection of old steps; a
checkpoint the reference's ``repro.distributed.CheckpointManager`` writes
from the same numpy tree restores into the port leaf for leaf (names,
order, values bitwise), and the port's checkpoint restores into the
reference's."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import CheckpointManager as JaxCheckpointManager
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.distributed import CheckpointManager
from repro_torch.models import TrainState
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten_with_names


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                       "layers": {"norm": rng.standard_normal((2, 6)).astype(np.float32)}},
            "lora": {"q": (rng.standard_normal((2, 3, 4, 2)).astype(np.float32),
                           rng.standard_normal((2, 3, 2, 6)).astype(np.float32))},
            "step": np.int32(7)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _equal(got, want):
    got, want = flatten_with_names(got), flatten_with_names(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        b = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.array(b))
        assert a.dtype == b.dtype and torch.equal(a, b), n


@pytest.mark.parametrize("use_async", [False, True], ids=["save", "save_async"])
def test_save_restore_round_trip_and_keep(tmp_path, use_async):
    mgr = CheckpointManager(tmp_path, keep=2)
    trees = [_torch_tree(_tree(s)) for s in range(3)]
    for step, tree in zip((10, 20, 30), trees):
        (mgr.save_async if use_async else mgr.save)(step, tree)
    if use_async:
        trees[2]["params"]["w"].zero_()  # the copy was taken at the call
    mgr.wait()
    assert mgr.latest_step() == 30
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000020",
                                                          "step_0000000030"]
    template = _torch_tree(_tree(5))
    _equal(mgr.restore(20, template), _torch_tree(_tree(1)))
    _equal(mgr.restore(30, template), _torch_tree(_tree(2)))


def test_a_failed_async_write_raises_in_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_0000000005.tmp").write_text("a file where the save makes a directory")
    mgr.save_async(5, _torch_tree(_tree()))
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # reported once
    assert mgr.latest_step() is None


def test_restore_refuses_another_tree(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _torch_tree(_tree()))
    bad = _torch_tree(_tree())
    bad["params"]["v"] = bad["params"].pop("w")
    with pytest.raises(ValueError, match="checkpoint leaf"):
        mgr.restore(1, bad)
    del bad["lora"]
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, bad)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A TrainState saved by the reference restores into the port's
    TrainState, and the port's into the reference's, bitwise."""
    rng = np.random.default_rng(3)
    params = {"embed": rng.standard_normal((8, 4)).astype(np.float32),
              "layers": {"wq": rng.standard_normal((2, 4, 4)).astype(np.float32),
                         "norm1": rng.standard_normal((2, 4)).astype(np.float32)}}
    lora = {"q": (rng.standard_normal((2, 3, 4, 2)).astype(np.float32),
                  rng.standard_normal((2, 3, 2, 4)).astype(np.float32))}
    jopt = jadamw_init({"params": params, "lora": lora})
    jopt = dataclasses.replace(jopt, m=jax.tree.map(lambda a: a + 1.5, jopt.m),
                               step=jnp.int32(4))
    jstate = jmodel.TrainState(params=jax.tree.map(jnp.asarray, params),
                               lora=jax.tree.map(jnp.asarray, lora), opt=jopt,
                               step=jnp.int32(4))
    JaxCheckpointManager(tmp_path / "ref").save(4, jstate)
    tparams, tlora = bridge.tensor_tree(params, "cpu"), bridge.tensor_tree(lora, "cpu")
    template = TrainState(params=tparams, lora=tlora,
                          opt=adamw_init({"params": tparams, "lora": tlora}),
                          step=torch.zeros((), dtype=torch.int32))
    got = CheckpointManager(tmp_path / "ref").restore(4, template)
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    got_leaves = flatten_with_names(got)
    assert len(got_leaves) == len(want)
    for (name, t), (_, a) in zip(got_leaves, want):
        assert t.dtype == torch.from_numpy(np.array(a)).dtype, name
        assert np.array_equal(t.numpy(), np.asarray(a)), name
    assert int(got.step) == 4 and int(got.opt.step) == 4
    CheckpointManager(tmp_path / "port").save(4, got)
    back = JaxCheckpointManager(tmp_path / "port").restore(4, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _run_main(monkeypatch, main, argv):
    monkeypatch.setattr("sys.argv", argv)
    main()


def test_train_launcher_checkpoints_resumes_and_refuses_compress(tmp_path, monkeypatch,
                                                                 capsys):
    """``python -m repro_torch.launch.train --device cpu``: checkpoints every
    ``--ckpt-every`` steps, a second run resumes from the latest, and a
    third with ``--compress`` builds the compression state and trains on
    (it was refused before the multi-device port; the step does not use
    it, ROADMAP Queue 3, pinned by ``tests/test_torch_distributed.py``)."""
    from repro_torch.launch import train

    args = ["train", "--arch", "qwen3-0.6b", "--batch", "2", "--seq", "8", "--device",
            "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _run_main(monkeypatch, train.main, args + ["--steps", "4"])
    assert CheckpointManager(tmp_path).latest_step() == 4
    _run_main(monkeypatch, train.main, args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and out.count("training done") == 2
    assert CheckpointManager(tmp_path).latest_step() == 6
    _run_main(monkeypatch, train.main, args + ["--steps", "8", "--compress"])
    out = capsys.readouterr().out
    assert "gradient compression: int8 + error feedback enabled" in out
    assert "resumed from step 6" in out and CheckpointManager(tmp_path).latest_step() == 8


def test_lora_example_trains_the_adapters_only_and_resumes(tmp_path, monkeypatch, capsys):
    """``examples/train_lora_torch.py --device cpu``: LoRA-only steps that
    leave the base weights as they were, checkpoints, resume."""
    import importlib.util

    from repro_torch.tree import leaves

    path = Path(__file__).resolve().parents[1] / "examples" / "train_lora_torch.py"
    spec = importlib.util.spec_from_file_location("train_lora_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    args = ["train_lora_torch", "--arch", "qwen3-0.6b", "--batch", "4", "--seq", "8",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _run_main(monkeypatch, example.main, args + ["--steps", "2"])
    mgr = CheckpointManager(tmp_path)
    from repro_torch import configs
    from repro_torch.models import build_model, make_train_state

    model = build_model(configs.reduced(configs.get("qwen3-0.6b")), dtype=torch.float32, device="cpu")
    fresh = make_train_state(model, torch.Generator().manual_seed(0), n_lora_slots=4,
                             train_lora_only=True)
    saved = mgr.restore(2, fresh)
    assert all(torch.equal(a, b) for a, b in zip(leaves(saved.params), leaves(fresh.params)))
    assert not all(torch.equal(a, b) for a, b in zip(leaves(saved.lora), leaves(fresh.lora)))
    _run_main(monkeypatch, example.main, args + ["--steps", "4"])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert mgr.latest_step() == 4
