"""95th percentile (nearest rank) over every request whose first token
came in the window of (first token on the host - its client's submit)."""
from bench.stats import percentile


def read(rec):
    if rec["kind"] != "serve" or not rec["ttft_s"]:
        return None
    return 1e3 * percentile(rec["ttft_s"], 95)
