"""mixer_gemm_roofline: the Mamba2 mixers' projections' share of their
roofline in the traced prefills, in %: Σ over the prefills of n_layers ×
(the bound of `in_proj` + the bound of `out_proj`) over Σ device s of
the `mixer.in_proj` and `mixer.out_proj` spans, each net of its
`weights.cast` children. A GEMM of M × K by K × N, M = rows × prompt
length (the `serve.generate` span's `rows` and `length`), is bounded by
the larger of 2MKN operations over the bf16 peak and 2(MK + KN + MN)
bytes (bf16 operands and output, each read or written once) over HBM's
(`counts.py`). in_proj: K = d_model, N = 2 d_inner + 2 G N_state + H;
out_proj: K = d_inner, N = d_model. Program spans
(`_program_spans.py`); nothing without device time."""
from gpubench import counts
from gpubench.metrics import _program_spans as ps


def gemm_bound_s(M: int, K: int, N: int) -> float:
    return max(2 * M * K * N / counts.PEAK_BF16_FLOPS,
               2 * (M * K + K * N + M * N) / counts.HBM_BYTES_PER_S)


def prefill_bound_s(arch: dict, rows: int, length: int) -> float:
    """The least time of every mixer's two projections in one prefill."""
    H, P, N, G = counts.ssd_dims(arch)
    d, di, M = arch["d_model"], H * P, rows * length
    return arch["n_layers"] * (gemm_bound_s(M, d, 2 * di + 2 * G * N + H)
                               + gemm_bound_s(M, di, d))


def read(run):
    bound = spent = 0.0
    for root, children in ps.calls():
        for pre in ps.kids(children, root, "serve.prefill"):
            if pre.device_s is None:
                return None
            bound += prefill_bound_s(run.arch, root.attrs["rows"], root.attrs["length"])
            spent += sum(ps.net_of_casts(children, s)
                         for name in ("mixer.in_proj", "mixer.out_proj")
                         for s in ps.under(children, pre, name))
    if spent <= 0:
        return None
    return 100.0 * bound / spent
