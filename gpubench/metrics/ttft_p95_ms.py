"""ttft_p95_ms: the 95th percentile, over every request completed in the
window, of its time to first token: from its batch's call into the engine
(host clock) to its first token on the host, which is the call's whole
time less the engine's decode steps after it (`stats["decode_s"]`, each
timed from the step's start to its tokens on the host). Percentile by
`statistics.quantiles(n=20, method="inclusive")`."""
import statistics


def read(run):
    ttft = []
    for b in run.batches:
        ttft.extend([(b.t1 - b.t0 - sum(b.decode_s)) * 1e3] * b.rows)
    if len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=20, method="inclusive")[18]
