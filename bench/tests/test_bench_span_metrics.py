"""The readers of the program's spans: each gives the mean it documents
over a recorded window, and None on a record from a program without the
spans; each entry has a reader and the layer of an older metric."""
import pytest

from bench import harness

ROOT = harness.BENCH.parent
PLAIN = ("step_host_ms", "step_launch_ms", "decode_graph_ms",
         "admit_host_ms")
NAMES = PLAIN + tuple(f"{n}.long_answer_c16" for n in PLAIN)


def step(**kw):
    e = {"active": 4, "width": 1, "positions": 4, "budget": 16}
    e.update(kw)
    return e


def record():
    steps = [step(host_step_s=0.010, host_plan_s=0.001, host_upload_s=0.001,
                  host_launch_s=0.004, host_wait_s=0.003,
                  host_commit_s=0.001, graph_device_s=0.008),
             step(host_step_s=0.014, host_plan_s=0.002, host_upload_s=0.001,
                  host_launch_s=0.006, host_wait_s=0.004,
                  host_commit_s=0.001, graph_device_s=0.010)]
    admits = [{"slots": [0], "bucket": 64, "computed_tokens": 40,
               "host_admit_s": 0.050, "host_wait_s": 0.030, "rids": [7]},
              {"slots": [1, 2], "bucket": 128, "computed_tokens": 200,
               "host_admit_s": 0.090, "host_wait_s": 0.060, "rids": [8, 9]}]
    return {"kind": "serve", "step_log": steps, "prefill_log": admits}


@pytest.mark.parametrize("suffix", ["", ".long_answer_c16"])
@pytest.mark.parametrize("name, mean", [
    ("step_host_ms", 8.5),          # (10 - 3 + 14 - 4) / 2
    ("step_launch_ms", 5.0),
    ("decode_graph_ms", 9.0),
    ("admit_host_ms", 25.0),        # (50 - 30 + 90 - 60) / 2
])
def test_each_reader_gives_its_mean(name, mean, suffix):
    assert harness.reader(name + suffix)(record()) == pytest.approx(mean)


@pytest.mark.parametrize("name", PLAIN)
def test_entries_a_profiler_touched_are_left_out(name):
    # a traced run: the profiled stretch and every call after it are
    # marked, and read ten times slower
    rec = record()
    want = harness.reader(name)(rec)
    slow = record()
    for log in (slow["step_log"], slow["prefill_log"]):
        for e in log:
            e.update({k: 10 * v for k, v in e.items()
                      if k.endswith("_s")}, profiled=True)
    for key in ("step_log", "prefill_log"):
        rec[key] += slow[key]
    assert harness.reader(name)(rec) == pytest.approx(want)
    assert harness.reader(name)(slow) is None


def test_a_forward_without_the_step_fields_is_left_out():
    rec = record()
    # a diffusion step: the step's fields on its last forward only, and
    # no device time where nothing was read back
    rec["step_log"].insert(0, step(step_latency_s=0.001))
    rec["step_log"][1].pop("graph_device_s")
    assert harness.reader("step_host_ms")(rec) == pytest.approx(8.5)
    assert harness.reader("decode_graph_ms")(rec) == pytest.approx(10.0)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_spans(name):
    old = {"kind": "serve", "step_log": [step(step_latency_s=0.01)],
           "prefill_log": [{"slots": [0], "bucket": 64,
                            "computed_tokens": 40}]}
    assert harness.reader(name)(old) is None
    assert harness.reader(name)({"kind": "train"}) is None


def test_every_span_metric_has_a_reader_and_an_older_layer():
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in spec["per_layer"]}
    older = {m["layer"] for m in spec["per_layer"] if m["name"] not in NAMES}
    twin = ["stablelm_3b.long_answer_c16"]
    for name in NAMES:
        m = entries[name]
        harness.reader(name)
        assert m["layer"] in older
        assert m["source"] in ("host_clock", "device_trace")
        assert (m["workloads"] == twin) == name.endswith(".long_answer_c16")
        assert "stablelm_3b.train_8x256" not in m["workloads"]
