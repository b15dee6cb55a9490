"""6 x parameters x tokens trained in the window over the window's
seconds at the card's bf16 peak (remat's recompute not counted)."""
from bench.roofline import counts, peaks


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    flops = counts.train_flops(rec["spec"], rec["tokens"])
    return 100.0 * flops / (rec["window_s"] * peaks.BF16_FLOPS)
