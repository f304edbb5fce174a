"""decode_step_ms: the mean of the engine's decode steps in the window
(`Engine.stats["decode_s"]`: host clock, from a step's start to its
tokens on the host)."""


def read(run):
    steps = [s for b in run.batches for s in b.decode_s]
    if not steps:
        return None
    return sum(steps) / len(steps) * 1e3
