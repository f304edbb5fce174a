"""shared_attn_roofline: the attention cores' share of their roofline in
the traced prefills, in %: Σ bound over Σ device s of the `attn.core`
spans under `serve.prefill` (program spans, `_program_spans.py`). Each
span's bound, from its attrs alone (rows, heads, kv_heads, head_dim,
q_len, kv_len), is the larger of the causal attention's operations,
4 · rows · heads · head_dim · q_len (q_len + 1) / 2, over the bf16 peak,
and its bytes, q, k and v read and the output written once in bf16,
over HBM's (`counts.py`). Nothing where the program records no such
span or the spans carry no device time (no card)."""
from gpubench import counts
from gpubench.metrics import _program_spans as ps


def attn_bound_s(attrs: dict) -> float:
    """The least time of one causal attention core of the span's shape."""
    rows, H, hd = attrs["rows"], attrs["heads"], attrs["head_dim"]
    S, T = attrs["q_len"], attrs["kv_len"]
    KV = attrs.get("kv_heads", H)
    flops = 4.0 * rows * H * hd * S * (S + 1) / 2
    nbytes = 2.0 * rows * hd * (2 * H * S + 2 * KV * T)
    return max(flops / counts.PEAK_BF16_FLOPS, nbytes / counts.HBM_BYTES_PER_S)


def read(run):
    bound = spent = 0.0
    for root, children in ps.calls():
        for pre in ps.kids(children, root, "serve.prefill"):
            for s in ps.under(children, pre, "attn.core"):
                if s.device_s is None:
                    return None
                bound += attn_bound_s(s.attrs)
                spent += s.device_s
    if spent <= 0:
        return None
    return 100.0 * bound / spent
