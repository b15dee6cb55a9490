"""Model FLOPs of the positions the window needed (every admitted
prompt's positions and every decode position: 2 x the parameters a
position multiplies with, plus attention over its context) over the
window's seconds at the card's bf16 peak."""
from bench.roofline import counts, peaks


def read(rec):
    if rec["kind"] != "serve" or not rec["decode_rows"]:
        return None
    s = rec["spec"]
    flops = sum(counts.prefill_flops(s, p) for p in rec["prompt_lens"])
    flops += (2.0 * counts.matmul_params(s) * sum(rec["decode_rows"])
              + counts.attention_flops(s, sum(rec["decode_ctx"])))
    return 100.0 * flops / (rec["window_s"] * peaks.BF16_FLOPS)
