"""The collective bytes of a serving or train step split over a model
axis (`repro_torch/parallel/tensor.py`), by formula: shared by
tests/test_torch_tp.py, tests/test_torch_tp_train.py,
tests/test_torch_tp_ssm.py, tests/test_torch_tp_ssm_train.py,
tests/test_torch_tp_moe.py and tests/test_torch_dryrun.py."""


def split_collectives(cfg, kind: str, rows: int, S: int, m: int) -> dict:
    """Per layer an all-reduce of (rows, S, D) after attention where heads
    split and after the MLP where ffn splits (after a MoE block where its
    experts split: its partial output); where the vocab splits, the
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
    ffn = (cfg.n_experts if cfg.family == "moe" else cfg.d_ff) % m == 0
    heads, vocab, by_seq = H % m == 0, V % m == 0, KV % m != 0
    ar = act * vocab + L * (act * heads + act * ffn)
    ag = rows * V * e * vocab
    n = 2 * vocab + L * (heads + ffn)
    if kind == "decode" and by_seq:
        ar += L * (rows * H * 4 + rows * H * (hd + 1) * 4)
        ag += L * rows * H * hd * e * heads
        n += L * (2 + heads)
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0, "_num_ops": n}


def _cut(info, data: int, model: int) -> tuple:
    """(model-cut shape, model- and data-cut shape, axes, data shard?) of a
    leaf: dims named heads, kv_heads, ffn, vocab or experts cut over "model" where
    they divide it (a Mamba2 leaf's segmented dim by heads, where its
    heads split: H/m heads a rank, G/m groups where m divides G, else
    one), its fsdp dim over "data" where that divides."""
    import math
    ml, axes = [], set()
    for n, lg in zip(info.shape, info.logical):
        if info.segments and lg in ("ffn", "heads"):
            H, G, segments = info.segments
            if model > 1 and H % model == 0 and (G % model == 0 or model % G == 0):
                gl = G // model if G % model == 0 else 1
                n = sum(w * (H // model if kind == "heads" else gl) for kind, w in segments)
                axes.add("model")
        elif (lg in ("heads", "kv_heads", "ffn", "vocab", "experts") and model > 1
              and n % model == 0):
            n //= model
            axes.add("model")
        ml.append(n)
    sl, sharded = list(ml), False
    if "fsdp" in info.logical:
        d = info.logical.index("fsdp")
        if data > 1 and sl[d] % data == 0:
            sl[d] //= data
            sharded = True
            axes.add("data")
    return math.prod(ml), math.prod(sl), axes, sharded


def _state_collectives(cfg, *, data: int, model: int, mb: int, seq: int, accum: int) -> list:
    """[all-reduce, all-gather, reduce-scatter bytes, and their op counts]
    of a train step's state and loss, whatever the family: FSDP (each
    stacked layer leaf's fsdp shards all-gathered twice a microbatch, the
    forward's and remat's recompute, every other's once; each
    reduce-scattered once, to its shard), the sums over "data" after the
    accumulation (each leaf that is not a data shard), the loss's sums
    (the nll and the token count; where the vocab splits, the embedding's
    all-reduce, vocab_nll's three fp32 all-reduces and the head's
    `copy_to` gradient), and the global norm's one fp32 sum a leaf for
    each set of axes that cuts leaves."""
    from repro_torch.models import api
    from repro_torch.models.base import tree_items
    L, D = cfg.n_layers, cfg.d_model
    act = mb * seq * D * 2
    ag = rs = ar = 0
    n_ag = n_rs = n_ar = 0
    norm_sets: dict = {}
    for path, info in tree_items(api.abstract_params(cfg)):
        mn, sn, axes, sharded = _cut(info, data, model)
        layered = path[0] == "layers"
        if sharded:
            times, ops = (2, 2 * L) if layered else (1, 1)
            ag += accum * times * 4 * mn
            n_ag += accum * ops
            rs += accum * 4 * sn
            n_rs += accum * (L if layered else 1)
        else:
            ar += 4 * sn
            n_ar += 1
        if axes:
            norm_sets[frozenset(axes)] = norm_sets.get(frozenset(axes), 0) + 1
    ar += accum * 8
    n_ar += accum * 2
    if model > 1 and cfg.vocab % model == 0:
        ar += accum * (2 * act + 3 * mb * seq * 4)
        n_ar += accum * 5
    ar += sum(4 * n for n in norm_sets.values())
    n_ar += len(norm_sets)
    return [ar, ag, rs, n_ar, n_ag, n_rs]


def _breakdown(ar, ag, rs, n_ar, n_ag, n_rs) -> dict:
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": rs, "all-to-all": 0,
            "collective-permute": 0, "_num_ops": n_ar + n_ag + n_rs}


def _dense_layers(cfg, L: int, model: int, mb: int, seq: int, remat: bool,
                  mlp: bool = True) -> tuple:
    """(all-reduce bytes, ops) of L dense layers' split over "model" in a
    microbatch: where the heads split, attention's output all-reduced
    (again in remat's recompute) and x's gradient once, and where the kv
    heads then stay whole, k's and v's gradients (rows, S, KV, hd); where
    the ffn splits, the MLP's output all-reduced once (remat's recompute
    stops before the down projection, whose output the backward does not
    save) and x's gradient once."""
    act = mb * seq * cfg.d_model * 2
    ar = n = 0
    if model > 1 and cfg.n_heads % model == 0:
        ar += L * (2 + remat) * act
        n += L * (2 + remat)
        if cfg.n_kv_heads % model != 0:
            ar += L * 2 * mb * seq * cfg.n_kv_heads * cfg.head_dim * 2
            n += L * 2
    if mlp and model > 1 and cfg.d_ff % model == 0:
        ar += L * 2 * act
        n += L * 2
    return ar, n


def train_collectives(cfg, *, data: int, model: int, batch: int, seq: int, accum: int) -> dict:
    """The collectives of one dense train step (remat "full", bf16 compute)
    on a (data, model) mesh under the trainer's rules, by kind and
    `_num_ops`, as the dry run's `collective_breakdown`: the state's and
    the loss's (`_state_collectives`), and per microbatch of
    `batch // data // accum` rows every layer's split (`_dense_layers`)."""
    mb = batch // data // accum
    c = _state_collectives(cfg, data=data, model=model, mb=mb, seq=seq, accum=accum)
    ar, n = _dense_layers(cfg, cfg.n_layers, model, mb, seq, remat=True)
    c[0] += accum * ar
    c[3] += accum * n
    return _breakdown(*c)


def ssm_train_collectives(cfg, *, data: int, model: int, batch: int, seq: int,
                          accum: int) -> dict:
    """The collectives of one ssm or hybrid train step (remat "full", bf16
    compute) on a (data, model) mesh under the trainer's rules, by kind
    and `_num_ops`: the state's and the loss's (`_state_collectives`; the
    hybrid's shared block is gathered once a forward), and where the
    mixer splits by heads (`tensor.ssm_splits`):

    * per mixer and microbatch, its output all-reduced once (remat's
      recompute stops before `out_proj`), the gated norm's fp32 sums of
      squares (rows, S, 1) three times (the forward, the recompute and
      the backward of `sum_over`), and xin's gradient once (`copy_to`);
    * once a step, one fp32 all-reduce of the gradients each rank holds
      its heads' part of: the per-head vectors (3 L H + L d_inner) and,
      where m > G, the shared B and C, G groups wide, of `in_proj` (its
      data shard's rows), `conv_w` and `conv_b`;

    and the hybrid's shared block at each of its n_layers / attn_every
    sites as a dense layer that is not remat'd (`_dense_layers`)."""
    from repro_torch.parallel import tensor
    L, D, H, G, N = cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    mb = batch // data // accum
    c = _state_collectives(cfg, data=data, model=model, mb=mb, seq=seq, accum=accum)
    if model > 1 and tensor.ssm_splits(H, G, model):
        c[0] += accum * L * (mb * seq * D * 2 * 2 + 3 * mb * seq * 4)
        c[3] += accum * L * 5
        summed = 3 * L * H + L * cfg.d_inner
        if model > G:
            rows = D // data if D % data == 0 else D
            summed += L * (rows + cfg.conv_width + 1) * 2 * G * N
        c[0] += 4 * summed
        c[3] += 1
    if cfg.family == "hybrid":
        ar, n = _dense_layers(cfg, L // cfg.attn_every, model, mb, seq, remat=False)
        c[0] += accum * ar
        c[3] += accum * n
    return _breakdown(*c)


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


def moe_train_collectives(cfg, *, data: int, model: int, batch: int, seq: int,
                          accum: int) -> dict:
    """The collectives of one MoE train step (remat "full", bf16 compute) on
    a (data, model) mesh under the trainer's rules, by kind and
    `_num_ops`: the state's and the loss's (`_state_collectives`; the
    experts' E dim cut over "model" where it divides), the attention of
    every layer as the dense family's (`_dense_layers`, without an MLP),
    and per MoE block and microbatch of mb = `batch // data // accum`
    rows (T = mb seq tokens):

    * the router's statistics summed over "data" (a group of one rank
      too) in the forward and again in remat's recompute: the
      probabilities' and the assignments' sums (E fp32 each) and the
      z-loss's (one fp32), three all-reduces; and where data > 1 the
      assignments of every data rank gathered for the experts' queues
      (`exclusive_sum`: data x E fp32), one all-gather;
    * where the experts split over "model", the partial output (T, D)
      all-reduced once (remat's recompute stops before it: nothing after
      it is saved for the backward), and the gradients of the tokens
      that enter the buffer (T, D) and of the gates (T, K) fp32
      all-reduced once each (the two `copy_to`s)."""
    L, D, E, K = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.experts_per_token
    mb = batch // data // accum
    T = mb * seq
    c = _state_collectives(cfg, data=data, model=model, mb=mb, seq=seq, accum=accum)
    ar, n = _dense_layers(cfg, L, model, mb, seq, remat=True, mlp=False)
    ar += L * 2 * (2 * E + 1) * 4
    n += L * 2 * 3
    if data > 1:
        c[1] += accum * L * 2 * data * E * 4
        c[4] += accum * L * 2
    if model > 1 and E % model == 0:
        ar += L * (2 * T * D * 2 + T * K * 4)
        n += L * 3
    c[0] += accum * ar
    c[3] += accum * n
    return _breakdown(*c)
