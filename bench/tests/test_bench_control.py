"""The check fails what it must: the reference in TF32 in the program's
place (the control; TF32 emulated on the CPU by rounding the products'
operands), and the program with its timed path broken underneath."""
import pytest

from conftest import TINY, run_tiny

CELLS = [f"{name}.train" for name in TINY]


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(tiny_root, cell):
    from bench import control, spec
    rows = control.control_numbers(spec.load(tiny_root), cell, [21, 22, 23],
                                   device="cpu", root=tiny_root)
    assert not any(r["correct"] for r in rows), rows
    assert all(r["grad_gap"] > 3 * 1e-6 for r in rows)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged",
                                   "leaf_frozen"])
def test_a_broken_step_is_not_correct(tiny_root, cell, fault):
    r = run_tiny(tiny_root, cell, fault=fault)
    assert r["correct"] is False
    checks = r["checks"]
    if fault == "state_unchanged":
        # every leaf's change is nought: each gap is 1 for the leaves at
        # or above the median norm, so the median gap is about 1
        assert checks["update_gap"]["value"] > 0.5
        assert checks["grad_gap"]["value"] > 0.5
    elif fault == "leaf_frozen":
        # one leaf of many reads 1; the median leaf is far below it
        assert checks["update_gap"]["value"] < 0.1
        assert checks["leaf_gap"]["value"] > 0.5
    else:
        assert checks["batch_rows_off"]["value"] > 0


def test_control_needs_a_card(tiny_root, monkeypatch, capsys):
    import torch

    from bench import control
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert control.main(["--workload", CELLS[0], "--seeds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_random_partition_reads_chance(tiny_root):
    from bench import control, spec
    for cell in CELLS:
        r = control.random_partition(spec.load(tiny_root), cell, tiny_root)
        assert r["partition_vs_chance"] > 0.8
