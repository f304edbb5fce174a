"""setup_s: from the process's start to the first timed batch (imports,
CUDA context, kernel build or load, the weights' draw, the engine, and one
warm batch of each prompt length)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
