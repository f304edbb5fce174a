"""prefill_glue_share: the share of the traced prefills' device time, in
%, that is neither the mixers' GEMMs, their SSD scans nor the head: 100 ×
(Σ device s of `serve.prefill` − Σ device s of `mixer.in_proj`,
`mixer.out_proj` and `mixer.ssd` under it, each net of its
`weights.cast` children, and of `model.head`) / Σ device s of
`serve.prefill`. What is left is the elementwise glue: the weight casts,
the conv, the gated norm, the layers' norms and residuals, the state's
casts and the cache's stack. Program spans (`_program_spans.py`);
nothing where they carry no device time (no card) or are not recorded."""
from gpubench.metrics import _program_spans as ps

_WORK = ("mixer.in_proj", "mixer.out_proj", "mixer.ssd")


def read(run):
    total = work = 0.0
    for root, children in ps.calls():
        for pre in ps.kids(children, root, "serve.prefill"):
            if pre.device_s is None:
                return None
            total += pre.device_s
            work += sum(ps.net_of_casts(children, s)
                        for name in _WORK for s in ps.under(children, pre, name))
            work += sum(s.device_s for s in ps.under(children, pre, "model.head"))
    if total <= 0:
        return None
    return 100.0 * (total - work) / total
