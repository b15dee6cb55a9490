"""Everything a cell needs is found by name, and BENCHMARK.json keeps to
the shape its format asks for."""
import json
import re
import textwrap

from bench import harness

ROOT = harness.BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    return harness.load_json(ROOT / "BENCHMARK.json")


def test_a_traffic_file_and_a_reader_dropped_in_are_found(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "burst_c8.json").write_text(
        json.dumps({"driver": "serve_closed", "clients": 8}))
    (tmp_path / "metrics" / "queue_ms.serve.py").write_text(textwrap.dedent(
        '''
        def read(rec):
            return rec.get("queue_s", 0.0) * 1e3
        '''))
    assert harness.traffic("burst_c8", tmp_path)["clients"] == 8
    assert harness.reader("queue_ms.serve", tmp_path)({"queue_s": 2}) == 2000
    cell = harness.Cell("x", 1, {}, {"driver": "serve_closed"}, {},
                        [{"name": "queue_ms.serve", "unit": "ms"}])
    (tmp_path / "drivers").mkdir()
    (tmp_path / "drivers" / "serve_closed.py").write_text(textwrap.dedent(
        '''
        def run(job):
            return {"correct": True, "attempted": 3, "failed": 0,
                    "device": {"memory_peak_bytes": 0}, "queue_s": 0.5,
                    "checks": {"c": {"value": 0, "limit": 1}}}
        '''))
    out = harness.execute(harness.Run(cell, 1, 1.0, False, 0.0, "cpu"),
                          bench_dir=tmp_path)
    assert out["metrics"] == {"queue_ms.serve": {"value": 500.0,
                                                 "unit": "ms"}}
    assert list(out)[-1] == "checks"


def test_every_cell_has_its_files_and_every_metric_a_reader():
    s = spec()
    for w in s["workloads"]:
        for trace in (False, True):
            cell = harness.load_cell(ROOT, w["name"], trace)
            assert cell.metrics
            harness.driver(cell.traffic["driver"])
            for m in cell.metrics:
                harness.reader(m["name"])
        assert "setup_s" in [m["name"] for m in
                             harness.cell_metrics(s, w["name"], False)]
        assert len(harness.cell_metrics(s, w["name"], False)) >= 2


def test_names_units_and_keys_keep_the_format():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in s["configs"]]
    names += [w["name"] for w in s["workloads"]]
    names += [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in s["per_layer"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    assert 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) < 64 * 1024
