"""95th percentile (nearest rank) over every request that finished in
the window of (finish - first token) / (output tokens - 1)."""
from bench.stats import percentile


def read(rec):
    if rec["kind"] != "serve" or not rec["tpot_s"]:
        return None
    return 1e3 * percentile(rec["tpot_s"], 95)
