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


def train_collectives(cfg, *, data: int, model: int, batch: int, seq: int, accum: int) -> dict:
    """The collectives of one dense train step (remat "full", bf16 compute)
    on a (data, model) mesh under the trainer's rules, by kind and
    `_num_ops`, as the dry run's `collective_breakdown`. A leaf's dims
    named heads, kv_heads, ffn or vocab are cut over "model" where they
    divide it, its fsdp dim over "data" where that divides. Per
    microbatch of `batch // data // accum` rows:

    * FSDP: each layer's fsdp shards all-gathered twice (the forward and
      remat's recompute) and the embedding's once, at their model-cut
      fp32 size; each reduce-scattered once, to its shard;
    * the loss: the nll sum and token count over the data group (two
      fp32 scalars); where the vocab splits, the embedding's all-reduce
      of (rows, S, D), the vocab-split nll's three fp32 all-reduces of
      (rows, S), and the head's `copy_to` gradient;
    * per layer where the heads split: attention's output all-reduced
      twice (forward, recompute) and x's gradient once, and where the kv
      heads then stay whole, k's and v's gradients (rows, S, KV, hd);
      where the ffn splits, the MLP's output all-reduced once (remat's
      recompute stops before the down projection, whose output the
      backward does not save) and x's gradient once.

    After the accumulation each leaf that is not an fsdp shard is
    all-reduced over the data group, and the global norm all-reduces one
    fp32 sum a leaf for each set of axes that cuts leaves."""
    import math

    from repro_torch.models import api
    from repro_torch.models.base import tree_items
    e = 2
    L, D, H, KV, hd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.vocab)
    mb = batch // data // accum
    act = mb * seq * D * e
    ag = rs = ar = 0
    n_ag = n_rs = n_ar = 0
    norm_sets: dict = {}
    for path, info in tree_items(api.abstract_params(cfg)):
        ml, axes, sharded = [], set(), False
        for n, lg in zip(info.shape, info.logical):
            if lg in ("heads", "kv_heads", "ffn", "vocab") and model > 1 and n % model == 0:
                n //= model
                axes.add("model")
            ml.append(n)
        sl = list(ml)
        if "fsdp" in info.logical:
            d = info.logical.index("fsdp")
            if data > 1 and sl[d] % data == 0:
                sl[d] //= data
                sharded = True
                axes.add("data")
        mbytes, sbytes = 4 * math.prod(ml), 4 * math.prod(sl)
        layered = path[0] == "layers"
        if sharded:
            times, ops = (2, 2 * L) if layered else (1, 1)
            ag += accum * times * mbytes
            n_ag += accum * ops
            rs += accum * sbytes
            n_rs += accum * (L if layered else 1)
        else:
            ar += sbytes
            n_ar += 1
        if axes:
            norm_sets[frozenset(axes)] = norm_sets.get(frozenset(axes), 0) + 1
    ar += accum * 8
    n_ar += accum * 2
    if model > 1 and V % model == 0:
        ar += accum * (2 * act + 3 * mb * seq * 4)
        n_ar += accum * 5
    if model > 1 and H % model == 0:
        ar += accum * L * 3 * act
        n_ar += accum * L * 3
        if KV % model != 0:
            ar += accum * L * 2 * mb * seq * KV * hd * e
            n_ar += accum * L * 2
    if model > 1 and cfg.d_ff % model == 0:
        ar += accum * L * 2 * act
        n_ar += accum * L * 2
    ar += sum(4 * n for n in norm_sets.values())
    n_ar += len(norm_sets)
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": rs, "all-to-all": 0,
            "collective-permute": 0, "_num_ops": n_ar + n_ag + n_rs}


def ssm_split_collectives(cfg, kind: str, rows: int, S: int, m: int) -> dict:
    """The collectives of an ssm or hybrid serving step split over a model
    axis of m (`layers/mamba2.py`): per Mamba2 mixer whose heads split
    (`tensor.ssm_splits`) one all-reduce of its output (rows, S, D) and
    one of the gated norm's fp32 sums of squares (rows, S, 1); the
    hybrid's shared block at each of its n_layers / attn_every sites as a
    dense layer, and the vocab's embedding and head, as
    `split_collectives` counts them. bf16 compute."""
    import dataclasses

    from repro_torch.parallel import tensor
    sites = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    out = split_collectives(dataclasses.replace(cfg, n_layers=sites), kind, rows, S, m)
    S = 1 if kind == "decode" else S
    mixers = cfg.n_layers * tensor.ssm_splits(cfg.ssm_heads, cfg.ssm_groups, m)
    out["all-reduce"] += mixers * (rows * S * cfg.d_model * 2 + rows * S * 4)
    out["_num_ops"] += 2 * mixers
    return out
