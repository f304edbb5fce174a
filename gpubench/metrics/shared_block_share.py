"""shared_block_share: the shared attention+MLP blocks' share of the
traced prefills' device time, in %: 100 × Σ device s of the
`zamba.shared_block` spans under `serve.prefill` over Σ device s of
`serve.prefill` (program spans, `_program_spans.py`). A block's span
holds its norms, attention, MLP with the site's adapter, and the site's
linear. Nothing where the program records no such span (a model without
Zamba2's shared blocks, or a program without the span) or the spans
carry no device time (no card)."""
from gpubench.metrics import _program_spans as ps


def read(run):
    total = blocks = 0.0
    for root, children in ps.calls():
        for pre in ps.kids(children, root, "serve.prefill"):
            spans = ps.under(children, pre, "zamba.shared_block")
            if pre.device_s is None or any(s.device_s is None for s in spans):
                return None
            total += pre.device_s
            blocks += sum(s.device_s for s in spans)
    if total <= 0 or blocks <= 0:
        return None
    return 100.0 * blocks / total
