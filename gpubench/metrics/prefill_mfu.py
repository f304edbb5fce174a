"""prefill_mfu: the whole prefill's share of the card's bf16 peak, in %:
the model's operations in every prefill of the window (`prefill_flops`
of the configuration's reference module, from shapes) over the engine's
summed `stats["prefill_s"]` (host clock, through the first token on the
host) and 989 TFLOP/s."""
from gpubench import counts


def read(run):
    if run.ctx.device.type != "cuda" or not run.batches:
        return None
    count = run.ctx.reference.prefill_flops
    flops = sum(count(run.arch, b.rows, b.length) for b in run.batches)
    seconds = sum(b.prefill_s for b in run.batches)
    return 100.0 * flops / seconds / counts.PEAK_BF16_FLOPS
