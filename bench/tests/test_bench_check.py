"""The output check fails what it must: the run is driven as a benchmark
run is (the look for a chip skipped, on the CPU at a tiny size), with the
timed path broken underneath, and ``correct`` comes out false; the fp8
control, put in the program's place and judged by the same rule, comes
out not correct."""
import numpy as np
import pytest
import torch

from bench import faults, harness, model_config, verdict, weights
from bench.reference import check
from bench.tests.conftest import TINY, TINY_LIMIT

SEED = 2 ** 31 + 77


def drive(cell, hooks=None):
    return harness.driver("serve_closed").run(harness.Run(
        cell, SEED, 3.0, False, 0.0, "cpu", hooks=hooks or {}))


@pytest.mark.parametrize("arch", sorted(TINY))
def test_a_sound_run_is_correct(tiny_cell, arch):
    rec = drive(tiny_cell(arch))
    assert rec["correct"], rec["checks"]
    assert rec["checks"]["served_tokens_compared"]["value"] >= 60


def test_the_fp8_control_is_not_correct(tiny_cell):
    """Tiny stablelm only: the tiny granite's tied head over a residual
    stream still close to its input embedding ranks the input token first
    by a wide margin, so fp8 rarely flips its choice there; granite's
    control is read at the cell's size on the card."""
    cell = tiny_cell("stablelm_3b")
    cell.traffic["check"] = {"max_requests": 30, "min_tokens": 2000}
    rec = drive(cell, {"control": True})
    assert rec["correct"], rec["checks"]
    assert rec["control_correct"] is False, rec["control_checks"]
    prog, ctrl = rec["gaps"]["program"], rec["gaps"]["control"]
    assert max(ctrl) >= 3 * max(prog)


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged",
                                   "half_batch"])
def test_a_broken_timed_path_is_not_correct(tiny_cell, fault):
    if fault == "token_altered":
        with faults.altered_tokens():
            rec = drive(tiny_cell("stablelm_3b"))
    else:
        rec = drive(tiny_cell("stablelm_3b"),
                    {"engine": faults.SERVING[fault]})
    assert not rec["correct"], rec["checks"]
    assert rec["checks"]["served_logit_gap"]["value"] > TINY_LIMIT


def test_the_reference_reads_a_served_greedy_stream_as_gap_zero():
    conf = TINY["stablelm_3b"]
    cfg, spec = model_config.arch_config(conf), model_config.shape_spec(conf)
    params = weights.make_params(cfg, conf, SEED, "cpu")
    from bench.reference import model
    prompt = np.arange(5, 17, dtype=np.int64)
    seq = list(prompt)
    for _ in range(6):                        # the reference's own greedy
        h = model.final_hidden(params, spec, torch.as_tensor(seq))
        seq.append(int(model.logits(params, spec, h[-1:]).argmax()))
    served = np.array(seq[len(prompt):])
    gaps = check.served_gaps(params, spec, [(prompt, served)], "cpu")
    assert gaps["program"] == [0.0]
    wrong = served.copy()
    wrong[3] = (wrong[3] + 1) % spec["vocab"]
    assert check.served_gaps(params, spec, [(prompt, wrong)],
                             "cpu")["program"][0] > 0


def test_the_sample_holds_the_longest_request():
    fin = [(np.zeros(3), np.zeros(n)) for n in (5, 50, 7, 9, 11)]
    picked = check.sample(fin, SEED, max_requests=3, min_tokens=10 ** 6)
    assert picked[0] == 1 and len(picked) == 3 and len(set(picked)) == 3
    assert check.sample(fin, SEED, 3, 10 ** 6) == picked
    assert check.sample(fin, SEED, 5, min_tokens=50) == [1]
    assert check.sample([], SEED, 3, 10) == []


def test_the_sample_holds_both_halves_of_the_slots():
    fin = [(np.zeros(3), np.zeros(n)) for n in (5, 50, 7, 9, 11, 13)]
    half = [0, 0, 0, 0, 0, 1]
    for seed in range(20):
        # the longest alone has the tokens asked for; the other half's
        # one request still joins it
        picked = check.sample(fin, seed, 3, min_tokens=10, half=half)
        assert picked == [1, 5]
        picked = check.sample(fin, seed, 4, 10 ** 6, half)
        assert picked[:2] == [1, 5] and len(picked) == 4
    assert check.sample(fin, SEED, 3, 10, [0] * 6) == [1]


def test_the_verdict_holds_every_limit_and_every_floor():
    lim = {"a": 1.0, "b": 2.0}
    assert verdict.judge({"a": 1.0, "b": 0.5}, lim) == (
        {"a": {"value": 1.0, "limit": 1.0},
         "b": {"value": 0.5, "limit": 2.0}}, True)
    assert not verdict.judge({"a": 1.5, "b": 0.5}, lim)[1]
    assert not verdict.judge({"a": 0.5, "b": None}, lim)[1]
    assert not verdict.judge({"a": 0.5}, lim)[1]
    checks, ok = verdict.judge({"a": 0.5, "b": 0.5, "c": 9.0}, lim,
                               {"n": (0, 1)})
    assert not ok and set(checks) == {"a", "b", "n"}
