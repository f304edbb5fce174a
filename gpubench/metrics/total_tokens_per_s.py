"""total_tokens_per_s: every prompt and generated token of the batches
completed in the window, over the whole window (host clock)."""


def read(run):
    if not run.batches or run.window_s <= 0:
        return None
    tokens = sum(b.rows * (b.length + run.new_tokens) for b in run.batches)
    return tokens / run.window_s
