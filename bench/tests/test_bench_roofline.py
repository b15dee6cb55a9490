"""Operation and byte counts against hand counts at both
configurations' shapes."""
import numpy as np
import pytest

from bench import harness, model_config
from bench.roofline import counts, peaks

ROOT = harness.BENCH.parent


def spec(name):
    return model_config.shape_spec(
        harness.load_json(ROOT / "bench" / "configs" / f"{name}.json"))


def test_stablelm_counts_by_hand():
    s = spec("stablelm_3b")
    attn = 4 * 2560 * 2560                     # q, k, v, o (MHA, dh 80)
    ffn = 3 * 2560 * 6912
    head = 2560 * 50304
    assert counts.matmul_params(s) == 32 * (attn + ffn) + head
    # every leaf of the port's tree: + the embedding and 2 norms a layer
    # + the final norm
    assert counts.param_count(s) == (32 * (attn + ffn + 2 * 2560)
                                     + 2 * 2560 * 50304 + 2560)
    assert counts.param_count(s) == 2795276800
    assert counts.train_flops(s, 2048) == 6 * 2795276800 * 2048


def test_granite_counts_by_hand():
    s = spec("granite_moe_3b_a800m")
    attn = 2 * 1536 * 24 * 64 + 2 * 1536 * 8 * 64
    active_ffn = 8 * 3 * 1536 * 512 + 1536 * 40  # top-8 experts + router
    assert counts.matmul_params(s) == 32 * (attn + active_ffn) + 1536 * 49155
    all_ffn = 40 * 3 * 1536 * 512 + 1536 * 40
    # tied: the embedding once
    assert counts.param_count(s) == (32 * (attn + all_ffn + 2 * 1536)
                                     + 1536 * 49155 + 1536)


def test_port_param_count_agrees():
    from repro_torch.configs import get_config
    for name in ("stablelm_3b", "granite_moe_3b_a800m"):
        s, cfg = spec(name), get_config(name)
        norms = 2 * s["layers"] * s["d"] + s["d"]
        assert counts.param_count(s) == cfg.param_count() + norms


def test_attention_and_prefill_flops():
    s = spec("stablelm_3b")
    assert counts.attention_flops(s, 100) == 4 * 32 * 32 * 80 * 100
    p = 7
    assert counts.prefill_flops(s, p) == pytest.approx(
        2 * counts.matmul_params(s) * p
        + 4 * 32 * 32 * 80 * sum(range(1, p + 1)))


def test_paged_attention_bound_by_hand():
    s = spec("stablelm_3b")
    lens = np.array([100, 300])
    # K and V of 101 + 301 positions x 32 heads x 80 x 2 B, q and out
    bytes_ = 2 * 402 * 32 * 80 * 2 + 2 * 2 * 1 * 32 * 80 * 2
    flops = 4 * 32 * 80 * 1 * 402
    want = max(bytes_ / peaks.HBM_BYTES_S, flops / peaks.BF16_FLOPS)
    assert counts.paged_attention_bound_s(s, lens, 1) == pytest.approx(want)
    assert bytes_ / peaks.HBM_BYTES_S > flops / peaks.BF16_FLOPS
    g = spec("granite_moe_3b_a800m")             # 8 kv heads of 64
    bytes_g = 2 * 402 * 8 * 64 * 2 + 2 * 2 * 24 * 64 * 2
    assert counts.paged_attention_bound_s(g, lens, 1) == pytest.approx(
        bytes_g / peaks.HBM_BYTES_S)
