"""CPU tests of the benchmark (``python -m pytest bench/tests`` from the
root of the repository; tests marked ``gpu`` need the card)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

TINY = {
    "stablelm_3b": {
        "arch": "stablelm_3b", "preset": "reduced", "num_hidden_layers": 2,
        "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "vocab_size": 256, "rope_theta": 10000,
        "tie_word_embeddings": False, "initializer_range": 0.02,
        "reduced": []},
    "granite_moe_3b_a800m": {
        "arch": "granite_moe_3b_a800m", "preset": "reduced",
        "num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 32,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "vocab_size": 256, "rope_theta": 10000,
        "tie_word_embeddings": True, "initializer_range": 0.02,
        "reduced": []},
}

#: the widest served-token gap a sound tiny run may show: the bf16
#: program on the CPU read up to 2.0e-3 against the f32 reference over
#: three seeds, the fp8 control 2.5e-2 at the least (tiny stablelm)
TINY_LIMIT = 6e-3


def tiny_serving(arch: str, mix: str = "long_answer_c16") -> dict:
    """The cell's traffic file cut to CPU size: 4 clients and slots,
    prompts 4-30, answers 8-40."""
    t = harness.traffic(mix)
    t.update(clients=4, slots=4, max_len=96,
             prompt_len=dict(t["prompt_len"], median=12, min=4, max=30),
             output_len=dict(t["output_len"], median=20, min=8, max=40),
             check={"max_requests": 4, "min_tokens": 60})
    return t


@pytest.fixture
def tiny_cell():
    def make(arch="stablelm_3b", metrics=(), mix="long_answer_c16"):
        return harness.Cell(f"tiny.{arch}", 1, dict(TINY[arch]),
                            tiny_serving(arch, mix),
                            {"served_logit_gap": TINY_LIMIT},
                            [{"name": m, "unit": "x"} for m in metrics])
    return make
