"""Prompt tokens admitted over positions the grid prefill computed
(``engine.batch`` x bucket) in the window's ``engine.prefill_log``."""


def read(rec):
    log = rec.get("prefill_log")
    if not log:
        return None
    grid = sum(rec["batch"] * e["bucket"] for e in log)
    return 100.0 * sum(e["computed_tokens"] for e in log) / grid
