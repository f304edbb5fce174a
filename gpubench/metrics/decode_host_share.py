"""decode_host_share: the share of the traced decode steps' host time, in
%, that the host spends issuing work rather than waiting for the step's
tokens: 100 × Σ (host s of `serve.decode_step` − host s of its
`serve.sync` children) / Σ host s of `serve.decode_step`. Program spans
(`_program_spans.py`)."""
from gpubench.metrics import _program_spans as ps


def read(run):
    total = issuing = 0.0
    for root, children in ps.calls():
        for step in ps.kids(children, root, "serve.decode_step"):
            total += step.duration_s
            issuing += step.duration_s - sum(
                s.duration_s for s in ps.kids(children, step, "serve.sync"))
    if total <= 0:
        return None
    return 100.0 * issuing / total
