"""ssd_scan_roofline: the SSD scan's share of its roofline, in %: the
least time of every mixer's scan in the traced prefills
(`counts.ssd_bound_s`, from shapes, whatever kernel runs it) over the
device time of the kernels whose name holds "ssd" (B7's `ssd_mma_kernel`
and `ssd_scan_kernel`). Nothing when the trace holds no such kernel."""
from gpubench import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    spent = t.kernel_s(lambda name: "ssd" in name.lower())
    if spent <= 0:
        return None
    arch = run.arch
    bound = sum(arch["n_layers"] * counts.ssd_bound_s(arch, rows, length)
                for rows, length in t.batches)
    return 100.0 * bound / spent
