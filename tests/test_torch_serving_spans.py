"""The host spans of the serving loop's decode step and admission
(``serving.spans``): every step's last ``step_log`` entry carries the
step's host time and its five phases, every admitting ``admit()``'s last
``prefill_log`` entry its five phases and request ids; the phases sum to
the whole; ``step_latency_s`` keeps its interval; a profiler sees each
phase as a ``record_function`` range nested in its call, and without one
no range is made; and the streams do not change.

On the CPU a ``capture=False`` paged engine serves a reduced stablelm,
greedy; the one ``gpu`` case checks the decode graph's device time on
the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_serving_spans.py
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from repro_torch.configs import get_config
from repro_torch.models import init_model
from repro_torch.serving import DecodeEngine, PagedKVConfig, ServingLoop
from repro_torch.serving.spans import (ADMIT_PHASES, LAUNCH, SELECT,
                                       STEP_PHASES, Phases, untimed)

SLOTS, MAX_LEN, REQUESTS, TOKENS = 4, 96, 6, 8


@pytest.fixture(scope="module")
def model():
    cfg = get_config("stablelm_3b", reduced=True)
    return cfg, init_model(cfg, torch.Generator().manual_seed(0), "cpu")


def _loop(model, device="cpu", capture=False):
    cfg, params = model
    eng = DecodeEngine(cfg, params, batch=SLOTS, max_len=MAX_LEN,
                       paged=PagedKVConfig(block_size=16), device=device,
                       capture=capture)
    loop = ServingLoop(eng, mode="greedy")
    rng = np.random.default_rng(0)
    for i in range(REQUESTS):
        loop.submit(rng.integers(0, cfg.vocab_size, size=5 + 3 * i), TOKENS)
    return loop


def _serve(model, **kw):
    loop = _loop(model, **kw)
    return loop, loop.run()


@pytest.fixture(scope="module")
def served(model):
    return _serve(model)


@pytest.fixture(scope="module")
def profiled(model):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        loop, streams = _serve(model)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.is_user_annotation()]
    return loop, streams, ranges


def _covers(whole, phases):
    total = sum(phases)
    return min(phases) >= 0 and 0.95 * whole <= total <= whole * (1 + 1e-9)


def test_every_step_carries_its_phases(served):
    loop, _ = served
    assert loop.step_log
    for e in loop.step_log:                    # greedy: a forward a step
        phases = [e[f"host_{p}_s"] for p in STEP_PHASES]
        assert _covers(e["host_step_s"], phases), e
        assert e["step_latency_s"] <= e["host_step_s"]
        assert "graph_device_s" not in e       # an eager CPU engine


def test_each_admission_carries_its_phases_and_rids(served):
    loop, _ = served
    log = loop.engine.prefill_log
    assert log and all("host_admit_s" in e for e in log)
    assert sorted(r for e in log for r in e["rids"]) == list(range(REQUESTS))
    for e in log:
        assert len(e["rids"]) == len(e["slots"])
        phases = [e[f"host_{p}_s"] for p in ADMIT_PHASES]
        assert _covers(e["host_admit_s"], phases), e
        assert e["host_prefill_s"] > 0 and e["host_scatter_s"] > 0


def test_every_phase_runs_at_some_step_and_admission(served):
    # a mark that moved out of its phase leaves that phase at zero
    loop, _ = served
    for log, phases in ((loop.step_log, STEP_PHASES),
                        (loop.engine.prefill_log, ADMIT_PHASES)):
        for p in phases:
            assert any(e[f"host_{p}_s"] > 0 for e in log), p


def test_a_name_that_is_no_phase_raises():
    clock = Phases()
    clock.start("serve.step", STEP_PHASES)
    clock.mark(SELECT)                         # admission's: no boundary
    assert clock._phase == STEP_PHASES[0]
    with pytest.raises(ValueError, match="no phase"):
        clock.mark("lanuch")
    clock.mark(LAUNCH)
    entry = {}
    clock.stop(entry)
    assert entry["host_launch_s"] >= 0 and "profiled" not in entry


def test_profiled_calls_are_marked_and_untimed_drops_the_spans(
        served, profiled):
    for loop, marked in ((served[0], False), (profiled[0], True)):
        for log in (loop.step_log, loop.engine.prefill_log):
            assert all(e.get("profiled", False) == marked for e in log)
    assert (untimed(served[0].engine.prefill_log)
            == untimed(profiled[0].engine.prefill_log))
    assert not any(k.startswith("host_") or k in ("rids", "profiled")
                   for e in untimed(profiled[0].step_log) for k in e)


def test_calls_after_a_profiler_stay_marked(model):
    # the profiler's cost outlasts it, so the engine's later calls are
    # marked too; a new engine's are not
    loop = _loop(model)
    loop.admit()
    loop.step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        loop.step()
    while loop.step():
        loop.admit()
    steps, admits = loop.step_log, loop.engine.prefill_log
    assert "profiled" not in steps[0] and "profiled" not in admits[0]
    assert all(e.get("profiled") for e in steps[1:]), steps
    assert len(admits) > 1 and all(e.get("profiled") for e in admits[1:])
    fresh = _loop(model)
    fresh.admit()
    fresh.step()
    assert not any("profiled" in e for e in fresh.step_log)


def test_step_latency_is_still_the_run_step_interval(model):
    loop = _loop(model)
    loop.admit()
    inner = []
    run_step, budget = loop.adapter.run_step, loop.budget

    def timed_run_step(*args):
        t0 = time.perf_counter()
        run_step(*args)
        inner.append(time.perf_counter() - t0)

    def slow_budget():
        time.sleep(0.2)
        return budget()

    loop.adapter.run_step, loop.budget = timed_run_step, slow_budget
    loop.step()
    e = loop.step_log[-1]
    # the budget's sleep is in the step and its plan phase, not in the
    # latency the controller observes
    assert inner[0] <= e["step_latency_s"] < inner[0] + 0.1
    assert e["host_step_s"] >= e["step_latency_s"] + 0.2
    assert e["host_plan_s"] >= 0.2


def test_streams_under_a_profiler_equal_those_without(served, profiled):
    assert served[1].keys() == profiled[1].keys()
    for rid, toks in served[1].items():
        np.testing.assert_array_equal(toks, profiled[1][rid])


def test_phases_are_user_annotations_nested_in_their_call(profiled):
    loop, _, ranges = profiled
    for span, phases, calls in (
            ("serve.step", STEP_PHASES, len(loop.step_log)),
            ("serve.admit", ADMIT_PHASES, None)):
        outer = [(s, e) for n, s, e in ranges if n == span]
        inner = [(n, s, e) for n, s, e in ranges
                 if n.startswith(span + ".")]
        if calls is not None:
            assert len(outer) == calls
        assert {n for n, _, _ in inner} == {f"{span}.{p}" for p in phases}
        for n, s, e in inner:
            assert any(a <= s and e <= b for a, b in outer), n


def test_no_range_is_made_without_a_profiler(model, monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _serve(model)
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _serve(model)
    assert made and all(n.startswith("serve.") for n in made)


@pytest.mark.gpu
def test_decode_graph_device_time_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode graph is timed by "
                    "CUDA events")
    cfg = get_config("stablelm_3b", reduced=True)
    params = init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    loop, _ = _serve((cfg, params), device="cuda", capture=True)
    assert loop.step_log
    for e in loop.step_log:
        assert 0 < e["graph_device_s"] <= e["host_step_s"], e
        phases = [e[f"host_{p}_s"] for p in STEP_PHASES]
        assert _covers(e["host_step_s"], phases), e
