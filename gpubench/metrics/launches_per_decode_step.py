"""launches_per_decode_step: kernels that ran on the device during the
traced cycle's decode steps, over the number of steps (`trace.py`)."""


def read(run):
    t = run.trace
    if t is None or t.decode_steps == 0 or t.decode_kernels == 0:
        return None
    return t.decode_kernels / t.decode_steps
