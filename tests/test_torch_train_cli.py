"""The port's LM training CLI (`repro_torch.launch.train`) on the CPU:
the loss falls on the Markov corpus, a run resumes from its checkpoint
exactly where an uninterrupted run would be, and train-state
checkpoints cross to and from the reference's `CheckpointManager`
(keys `params/…`, `mu/…`, `nu/…`, `step`). The reference's own CLI is
not run: on jax 0.9 it dies in its first step, in
`with_sharding_constraint` on the Explicit axes `jax.make_mesh` returns
(ROADMAP C, R5), so the port is held against its `make_train_step`
(tests/test_torch_lm_train.py) and its `CheckpointManager` here."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.dist.steps import spec_train_state as ref_spec_train_state
from repro.models.spec import init_tree as ref_init_tree
from repro.runtime import CheckpointManager as RefCheckpointManager
from repro_torch.configs import get_arch
from repro_torch.dist.steps import spec_train_state
from repro_torch.launch import train
from repro_torch.models.spec import init_tree, params_to_numpy
from repro_torch.nn.tree import tree_leaves
from repro_torch.runtime.checkpoint import CheckpointManager

ARGV = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch",
        "8", "--seq", "64", "--microbatches", "2", "--log-every", "1"]


def _run(*extra):
    return train.main(ARGV + list(extra))


def test_loss_falls_on_the_markov_corpus():
    """40 steps at lr 1e-2: from 6.256 (≈ ln 512) the mean of the last
    five reads 6.033; held to a fall of 0.15."""
    out = _run("--steps", "40", "--lr", "1e-2", "--log-every", "10")
    losses = [row["loss"] for row in out["history"]]
    assert [row["step"] for row in out["history"]] == list(range(1, 41))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 0.15
    assert all(row["grad_norm"] > 0 for row in out["history"])


def test_resume_continues_where_an_uninterrupted_run_would_be(tmp_path,
                                                              capsys):
    whole = _run("--steps", "8", "--lr", "1e-2")
    first = _run("--steps", "6", "--lr", "1e-2", "--ckpt", str(tmp_path),
                 "--ckpt-every", "2")
    assert [r["step"] for r in first["history"]] == list(range(1, 7))
    assert CheckpointManager(str(tmp_path)).steps() == [2, 4, 6]
    capsys.readouterr()
    second = _run("--steps", "8", "--lr", "1e-2", "--ckpt", str(tmp_path),
                  "--ckpt-every", "2")
    assert "restored checkpoint at step 6" in capsys.readouterr().out
    assert second["start_step"] == 6
    assert [r["step"] for r in second["history"]] == [7, 8]
    for got, want in zip(first["history"] + second["history"],
                         whole["history"]):
        assert got["loss"] == want["loss"] and got["acc"] == want["acc"]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _run("--steps", "3", "--lr", "1e-2", "--ckpt", str(tmp_path))
    ref_cfg = ref_get_arch("llama3.2-1b", True)
    template = ref_init_tree(ref_spec_train_state(ref_cfg),
                             jax.random.PRNGKey(9))
    restored = RefCheckpointManager(str(tmp_path)).restore(template)
    assert int(restored["step"]) == 3
    ours = CheckpointManager(str(tmp_path)).restore(
        init_tree(spec_train_state(get_arch("llama3.2-1b", True)),
                  torch.Generator().manual_seed(1), "cpu"))
    for part in ("params", "mu", "nu"):
        got = tree_leaves(params_to_numpy(ours[part]))
        want = jax.tree_util.tree_leaves(restored[part])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_reference_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """The reference's train state (its init, at step 4) resumes in the
    port's CLI, which trains on from the reference's params."""
    ref_cfg = ref_get_arch("llama3.2-1b", True)
    state = ref_init_tree(ref_spec_train_state(ref_cfg),
                          jax.random.PRNGKey(3))
    state["step"] = state["step"] + 4
    RefCheckpointManager(str(tmp_path)).save(4, state, blocking=True)
    restored = CheckpointManager(str(tmp_path)).restore(
        init_tree(spec_train_state(get_arch("llama3.2-1b", True)),
                  torch.Generator().manual_seed(0), "cpu"))
    for a, b in zip(tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(state["params"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    capsys.readouterr()
    out = _run("--steps", "6", "--ckpt", str(tmp_path))
    assert "restored checkpoint at step 4" in capsys.readouterr().out
    assert [r["step"] for r in out["history"]] == [5, 6]
    assert all(np.isfinite(r["loss"]) for r in out["history"])


def test_mesh_other_than_host_raises_naming_the_roadmap():
    """The production meshes need their 256 or 512 ranks: one process
    stops with a message naming them, never training on one device."""
    for mesh, n in (("pod", 256), ("multipod", 512)):
        with pytest.raises(SystemExit, match=rf"needs {n} ranks"):
            train.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                        "cpu", "--mesh", mesh])


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
