"""The metric arithmetic on recorded timelines."""
import pytest

from bench import harness, stats
from bench import trace as tracing


def read(name, rec):
    return harness.reader(name)(rec)


def serve_record(**kw):
    rec = {"kind": "serve", "setup_s": 12.5, "window_s": 4.0, "tokens": 1000,
           "batch": 4, "ttft_s": [], "tpot_s": [], "step_s": [],
           "admit_s": [], "step_log": [], "prefill_log": [],
           "decode_ctx": [], "decode_rows": [], "prompt_lens": []}
    rec.update(kw)
    return rec


def test_window_rate_is_all_tokens_over_all_time():
    assert read("decode_tok_s", serve_record()) == 250.0
    assert read("decode_tok_s", {"kind": "train"}) is None
    assert read("setup_s", serve_record()) == 12.5


def test_p95_is_nearest_rank_over_all_requests():
    ttft = [i / 1000 for i in range(1, 41)]          # 1..40 ms
    rec = serve_record(ttft_s=ttft, tpot_s=[0.01] * 19 + [0.5])
    # ceil(0.95 * 40) = 38th smallest
    assert read("ttft_p95_ms", rec) == pytest.approx(38.0)
    # ceil(0.95 * 20) = 19th: the one slow request is above it
    assert read("tpot_p95_ms", rec) == pytest.approx(10.0)
    assert stats.percentile([3.0], 95) == 3.0
    assert read("ttft_p95_ms", serve_record()) is None
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_prefill_useful_share_from_the_prefill_log():
    log = [{"slots": [0, 1], "bucket": 64, "computed_tokens": 100},
           {"slots": [3], "bucket": 512, "computed_tokens": 300}]
    rec = serve_record(prefill_log=log, batch=16)
    assert read("prefill_useful_pct", rec) == pytest.approx(
        100 * 400 / (16 * 64 + 16 * 512))


def test_step_and_admit_means_and_positions():
    rec = serve_record(step_s=[0.01, 0.02, 0.03], admit_s=[0.2],
                       step_log=[{"positions": 16}, {"positions": 15}])
    assert read("step_ms", rec) == pytest.approx(20.0)
    assert read("admit_ms", rec) == pytest.approx(200.0)
    assert read("positions_per_forward", rec) == 15.5


def test_busy_time_is_the_union_of_device_intervals():
    dev = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35)]
    assert tracing.merged(dev) == [(0, 20), (30, 40)]
    host = [("bench.step", 0, 50), ("cudaGraphLaunch", 21, 29)]
    gaps = tracing.idle_gaps(tracing.merged(dev), host, 0, 50)
    assert gaps == {"bench.step/cudaGraphLaunch": 10e-9,
                    "bench.step/(python)": 10e-9}
    st = tracing.Stretch(50e-9, 30e-9, {"void attn_kernel<true>(P)": 7e-9,
                                        "up_kernel<1>": 2e-9,
                                        "down_kernel": 1e-9}, gaps)
    rec = serve_record(stretch=st, attn_bound_s=3.5e-9)
    assert read("device_idle_pct.serve", rec) == pytest.approx(40.0)
    assert read("decode_attention_roofline", rec) == pytest.approx(50.0)
    assert read("moe_ffn_busy_pct", rec) == pytest.approx(10.0)
    assert read("device_idle_pct.train", rec) is None
    assert st.top(st.ops, 2)[0] == ["void attn_kernel<true>(P)", 7e-9]


def test_readers_find_nothing_without_a_trace():
    rec = serve_record()
    for name in ("device_idle_pct.serve", "decode_attention_roofline",
                 "moe_ffn_busy_pct", "mfu.serve", "step_ms", "admit_ms",
                 "positions_per_forward", "prefill_useful_pct"):
        assert read(name, rec) is None, name
