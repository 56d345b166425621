"""ttft_p95_ms: The 95th percentile over every request of the window of the
time from its send (its batch's start) to its first token on the host."""
from bench.harness import percentile


def read(rec: dict):
    if rec["kind"] != "serve":
        return None
    return 1e3 * percentile(rec["ttft_s"], 95.0)
