"""cache_init_ms: the mean over the traced calls of the device time of
`serve.cache_init`, the cache that `Engine.generate` draws for each call
(program spans, `_program_spans.py`); nothing without device time."""
from gpubench.metrics import _program_spans as ps


def read(run):
    times = [s.device_s for root, children in ps.calls()
             for s in ps.kids(children, root, "serve.cache_init")]
    if not times or any(t is None for t in times):
        return None
    return 1e3 * sum(times) / len(times)
