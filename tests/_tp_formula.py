"""The collective bytes of a dense serving step split over a model axis
(`repro_torch/parallel/tensor.py`), by formula: shared by
tests/test_torch_tp.py and tests/test_torch_dryrun.py."""


def split_collectives(cfg, kind: str, rows: int, S: int, m: int) -> dict:
    """Per layer an all-reduce of (rows, S, D) after attention where heads
    split and after the MLP where ffn splits; where the vocab splits, the
    embedding's all-reduce and the logits' all-gather (one position);
    and on a cache by positions at decode, the gathered queries (heads
    split) and the log-sum-exp's fp32 all-reduces of the max and of the
    contexts with their sums. bf16 compute; by kind and `_num_ops`, as
    the dry run's `collective_breakdown`."""
    e = 2                                           # bf16 compute
    L, D, H, KV, hd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.vocab)
    S = 1 if kind == "decode" else S
    act = rows * S * D * e
    heads, ffn, vocab, by_seq = H % m == 0, cfg.d_ff % m == 0, V % m == 0, KV % m != 0
    ar = act * vocab + L * (act * heads + act * ffn)
    ag = rows * V * e * vocab
    n = 2 * vocab + L * (heads + ffn)
    if kind == "decode" and by_seq:
        ar += L * (rows * H * 4 + rows * H * (hd + 1) * 4)
        ag += L * rows * H * hd * e * heads
        n += L * (2 + heads)
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0, "_num_ops": n}
