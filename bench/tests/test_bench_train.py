"""The training check at a tiny size on the CPU: the train driver runs as
a benchmark run does (the look for a chip skipped; the step eager, as
``compiled_train_step(capture=False)`` gives it), a sound run is correct,
and the fp8 control and each fault a training cell can have fail a
number."""
import pytest
import torch

from bench import faults, harness, model_config
from bench.tests.conftest import TINY

#: tiny stablelm, bf16 program on the CPU against the f32 reference over
#: three seeds: loss <= 3.5e-5, first gradient <= 6.5e-4, change <=
#: 8.1e-4; the fp8 control: >= 1.5e-4, >= 1.6e-3, >= 3.0e-3
TINY_TRAIN_LIMITS = {"loss_rel_gap": 8e-5, "first_grad_worst_leaf": 1.5e-3,
                     "change_worst_leaf": 1.2e-3}
SEED = 2 ** 31 + 5


def drive(hooks=None):
    t = harness.traffic("train_8x256")
    t.update(batch=4, seq_len=32)
    cell = harness.Cell("tiny.train", 1, dict(TINY["stablelm_3b"]), t,
                        TINY_TRAIN_LIMITS, [])
    return harness.driver("train").run(harness.Run(
        cell, SEED, 0.5, False, 0.0, "cpu", hooks=hooks or {}))


def test_a_sound_run_is_correct_and_the_control_is_not():
    rec = drive({"control": True})
    assert rec["correct"], rec["checks"]
    assert rec["steps"] >= 1 and rec["readings"]["left_out"] == []
    assert rec["control_correct"] is False, rec["control_checks"]
    assert set(rec["control_checks"]) == set(TINY_TRAIN_LIMITS)


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_a_broken_step_is_not_correct(fault):
    wrap = (faults.half_batch_step if fault == "half_batch" else
            faults.unchanged_step(model_config.arch_config(
                TINY["stablelm_3b"])))
    rec = drive({"step_fn": wrap})
    assert not rec["correct"], rec["checks"]
    assert (rec["checks"]["first_grad_worst_leaf"]["value"]
            > TINY_TRAIN_LIMITS["first_grad_worst_leaf"])


def test_the_reference_optimizer_follows_the_schedule():
    from bench.reference import train as ref_train
    opt = harness.traffic("train_8x256")["optimizer"]
    assert ref_train.lr_at(opt, 1) == pytest.approx(opt["lr"] / 4)
    assert ref_train.lr_at(opt, 4) == pytest.approx(opt["lr"])
    assert ref_train.lr_at(opt, opt["total_steps"]) == pytest.approx(
        opt["lr"] * opt["min_lr_ratio"])
    assert not ref_train.decays(("segments", 0, "ln1", "scale"))
    assert ref_train.decays(("segments", 0, "attn", "wq"))
    got = {("a",): 1.0, ("b",): 2.1, ("c",): 1e-6}
    want = {("a",): 1.0, ("b",): 2.0, ("c",): 0.0}
    # the near-zero leaf is measured against the median leaf's norm
    assert ref_train.worst_leaf(got, want) == pytest.approx(0.1 / 2.0)
    assert ref_train.moving({("a",): 1.0, ("b",): 2.0, ("c",): 1e-4}) == {
        ("a",), ("b",)}
    assert torch.isfinite(torch.tensor(ref_train.lr_at(opt, 500)))
