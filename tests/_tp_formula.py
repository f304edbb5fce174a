"""The collective bytes of a serving or train step split over a model
axis (`repro_torch/parallel/tensor.py`), by formula: shared by
tests/test_torch_tp.py, tests/test_torch_tp_train.py,
tests/test_torch_tp_ssm.py, tests/test_torch_tp_ssm_train.py,
tests/test_torch_tp_moe.py and tests/test_torch_dryrun.py."""


def _sp(S: int, m: int) -> bool:
    """Whether a hidden state of S positions splits along the sequence
    over a model axis of m (`tensor.seq_splits` of the dense family)."""
    return m > 1 and S % m == 0


def split_collectives(cfg, kind: str, rows: int, S: int, m: int, sp: bool | None = None
                      ) -> dict:
    """The collectives of a serving step split over a model axis of m, by
    kind and `_num_ops`, as the dry run's `collective_breakdown`; bf16
    compute. `sp` (default: S divides m, never at decode) splits the
    hidden state along the sequence between layers.

    Unsplit (a decode step, a ragged prompt): per layer an all-reduce of
    (rows, S, D) after attention where heads split and after the MLP
    where ffn splits (after a MoE block where its experts split: its
    partial output); where the vocab splits, the embedding's all-reduce
    and the logits' all-gather (one position); and on a cache by
    positions at decode, the gathered queries (heads split) and the
    log-sum-exp's fp32 all-reduces of the max and of the contexts with
    their sums.

    Split: where the vocab splits, the embedding's reduce-scatter to a
    rank's positions and the logits' all-gather; the last position's row
    all-gathered from every rank (rows, m, D); per layer, where heads
    split the input all-gathered along the sequence and the output
    reduce-scattered back, and where they stay whole k and v all-gathered
    (rows, S, KV, hd); the MLP's all-gather and reduce-scatter where ffn
    splits; a MoE block's input all-gathered, its two router statistics
    summed over the model group in one all-reduce (E + 1 fp32) and, where
    its experts split, the partial output reduce-scattered."""
    e = 2                                           # bf16 compute
    L, D, H, KV, hd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.vocab)
    S = 1 if kind == "decode" else S
    sp = _sp(S, m) if sp is None else sp
    act = rows * S * D * e
    moe = cfg.family == "moe"
    ffn = (cfg.n_experts if moe else cfg.d_ff) % m == 0
    heads, vocab, by_seq = H % m == 0, V % m == 0, KV % m != 0
    if sp:
        part = act // m
        ag = rows * m * D * e + rows * V * e * vocab + L * (
            act if heads else 2 * rows * S * KV * hd * e)
        rs = part * vocab + L * part * heads
        ar, n = 0, 1 + 2 * vocab + 2 * L
        if moe:
            ag += L * act
            ar += L * (cfg.n_experts + 1) * 4
            rs += L * part * ffn
            n += L * (2 + ffn)
        else:
            ag += L * act * ffn
            rs += L * part * ffn
            n += 2 * L * ffn
        return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": rs, "all-to-all": 0,
                "collective-permute": 0, "_num_ops": n}
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


_HEAD_VECTORS = ("a_log", "dt_bias", "d_skip", "norm_scale")


def _mixer_splits(cfg, model: int) -> bool:
    from repro_torch.parallel import tensor
    return cfg.family in ("ssm", "hybrid") and model > 1 and tensor.ssm_splits(
        cfg.ssm_heads, cfg.ssm_groups, model)


def _state_collectives(cfg, *, data: int, model: int, mb: int, seq: int, accum: int,
                       sp: bool = False) -> list:
    """[all-reduce, all-gather, reduce-scatter bytes, and their op counts]
    of a train step's state and loss, whatever the family: FSDP (each
    stacked layer leaf's fsdp shards all-gathered twice a microbatch, the
    forward's and remat's recompute, every other's once; each
    reduce-scattered once, to its shard), the sums over "data" after the
    accumulation (each leaf that is not a data shard), the loss's sums
    (the nll and the token count; where the vocab splits, the embedding's
    all-reduce, vocab_nll's three fp32 all-reduces and the head's
    `copy_to` gradient), and the global norm's one fp32 sum a leaf for
    each set of axes that cuts leaves.

    With the hidden state split along the sequence (`sp`): where the
    vocab splits, the embedding's reduce-scatter (forward) and
    all-gather (backward) and the head's all-gather of the sequence
    (forward) and reduce-scatter (backward) in place of the embedding's
    and the head's all-reduces; where it stays whole, the nll's and the
    token count's sums over the model group too; and once a step one
    fp32 all-reduce over the model group of every leaf held whole over
    "model" (a split mixer's per-head vectors are summed with its
    partial gradients instead)."""
    from repro_torch.models import api
    from repro_torch.models.base import tree_items
    L, D = cfg.n_layers, cfg.d_model
    act = mb * seq * D * 2
    ag = rs = ar = 0
    n_ag = n_rs = n_ar = 0
    norm_sets: dict = {}
    whole = 0
    mixer_split = _mixer_splits(cfg, model)
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
        if "model" not in axes and not (mixer_split and path[:2] == ("layers", "mixer")
                                        and path[-1] in _HEAD_VECTORS):
            whole += sn
    ar += accum * 8
    n_ar += accum * 2
    vocab = model > 1 and cfg.vocab % model == 0
    if vocab and sp:
        ag += accum * 2 * act
        rs += accum * 2 * (act // model)
        ar += accum * 3 * mb * seq * 4
        n_ag, n_rs, n_ar = n_ag + 2 * accum, n_rs + 2 * accum, n_ar + 3 * accum
    elif vocab:
        ar += accum * (2 * act + 3 * mb * seq * 4)
        n_ar += accum * 5
    elif sp:
        ar += accum * 8
        n_ar += accum * 2
    if sp and whole:
        ar += 4 * whole
        n_ar += 1
    ar += sum(4 * n for n in norm_sets.values())
    n_ar += len(norm_sets)
    return [ar, ag, rs, n_ar, n_ag, n_rs]


def _breakdown(ar, ag, rs, n_ar, n_ag, n_rs) -> dict:
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": rs, "all-to-all": 0,
            "collective-permute": 0, "_num_ops": n_ar + n_ag + n_rs}


def _add(c: list, d: list, times: int = 1) -> None:
    for i, v in enumerate(d):
        c[i] += times * v


def _dense_layers(cfg, L: int, model: int, mb: int, seq: int, remat: bool,
                  mlp: bool = True, sp: bool = False) -> list:
    """[all-reduce, all-gather, reduce-scatter bytes, and their op counts]
    of L dense layers' split over "model" in a microbatch.

    Unsplit: where the heads split, attention's output all-reduced (again
    in remat's recompute) and x's gradient once, and where the kv heads
    then stay whole, k's and v's gradients (rows, S, KV, hd); where the
    ffn splits, the MLP's output all-reduced once (remat's recompute stops
    before the down projection, whose output the backward does not save)
    and x's gradient once.

    With the sequence split (`sp`): where the heads split, x all-gathered
    and the output reduce-scattered in the forward and again in remat's
    recompute, and in the backward the output's gradient all-gathered and
    x's reduce-scattered; where they stay whole, k and v all-gathered in
    the forward and the recompute and their gradients reduce-scattered;
    where the ffn splits, the MLP's all-gather in the forward and the
    recompute, its reduce-scatter in the forward alone, and the backward's
    all-gather and reduce-scatter."""
    act = mb * seq * cfg.d_model * 2
    c = [0] * 6
    heads = model > 1 and cfg.n_heads % model == 0
    ffn = mlp and model > 1 and cfg.d_ff % model == 0
    if sp:
        part = act // model
        if heads:
            _add(c, [0, (2 + remat) * act, (2 + remat) * part, 0, 2 + remat, 2 + remat], L)
        elif model > 1:
            kv = mb * seq * cfg.n_kv_heads * cfg.head_dim * 2
            _add(c, [0, 2 * (1 + remat) * kv, 2 * (kv // model), 0, 2 * (1 + remat), 2], L)
        if ffn:
            _add(c, [0, (2 + remat) * act, 2 * part, 0, 2 + remat, 2], L)
        return c
    if heads:
        _add(c, [(2 + remat) * act, 0, 0, 2 + remat, 0, 0], L)
        if cfg.n_kv_heads % model != 0:
            _add(c, [2 * mb * seq * cfg.n_kv_heads * cfg.head_dim * 2, 0, 0, 2, 0, 0], L)
    if ffn:
        _add(c, [2 * act, 0, 0, 2, 0, 0], L)
    return c


def train_collectives(cfg, *, data: int, model: int, batch: int, seq: int, accum: int) -> dict:
    """The collectives of one dense train step (remat "full", bf16 compute)
    on a (data, model) mesh under the trainer's rules, by kind and
    `_num_ops`, as the dry run's `collective_breakdown`: the state's and
    the loss's (`_state_collectives`), and per microbatch of
    `batch // data // accum` rows every layer's split (`_dense_layers`),
    with the sequence split where seq divides the model axis."""
    mb = batch // data // accum
    sp = _sp(seq, model)
    c = _state_collectives(cfg, data=data, model=model, mb=mb, seq=seq, accum=accum, sp=sp)
    _add(c, _dense_layers(cfg, cfg.n_layers, model, mb, seq, remat=True, sp=sp), accum)
    return _breakdown(*c)


def ssm_train_collectives(cfg, *, data: int, model: int, batch: int, seq: int,
                          accum: int, mode: str = "mixed") -> dict:
    """The collectives of one ssm or hybrid train step (remat "full", bf16
    compute) on a (data, model) mesh under the trainer's rules, by kind
    and `_num_ops`: the state's and the loss's (`_state_collectives`; the
    hybrid's shared block is gathered once a forward), and where the
    mixer splits by heads (`tensor.ssm_splits`):

    * per mixer and microbatch, unsplit (`mode` "heads", or seq that does
      not divide), its output all-reduced once (remat's recompute stops
      before `out_proj`), the gated norm's fp32 sums of squares (rows, S,
      1) three times (the forward, the recompute and the backward of
      `sum_over`), and xin's gradient once (`copy_to`); with the sequence
      split, xin all-gathered in the forward, the recompute and (the
      output's gradient) the backward, the output reduce-scattered in the
      forward and xin's gradient in the backward, and the same three sums
      of squares; a mixer that stays whole then gathers in the forward
      and the recompute and reduce-scatters its gradient;
    * once a step, one fp32 all-reduce of the gradients each rank holds
      its heads' part of: the per-head vectors (3 L H + L d_inner) and,
      where m > G, the shared B and C, G groups wide, of `in_proj` (its
      data shard's rows), `conv_w` and `conv_b`;

    and the hybrid's shared block at each of its n_layers / attn_every
    sites as a dense layer that is not remat'd (`_dense_layers`)."""
    L, D, H, G, N = cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    mb = batch // data // accum
    sp = mode != "heads" and _sp(seq, model)
    act = mb * seq * D * 2
    c = _state_collectives(cfg, data=data, model=model, mb=mb, seq=seq, accum=accum, sp=sp)
    if _mixer_splits(cfg, model):
        norm = 3 * mb * seq * 4
        if sp:
            _add(c, [norm, 3 * act, 2 * (act // model), 3, 3, 2], accum * L)
        else:
            _add(c, [2 * act + norm, 0, 0, 5, 0, 0], accum * L)
        summed = 3 * L * H + L * cfg.d_inner
        if model > G:
            rows = D // data if D % data == 0 else D
            summed += L * (rows + cfg.conv_width + 1) * 2 * G * N
        _add(c, [4 * summed, 0, 0, 1, 0, 0])
    elif sp:
        _add(c, [0, 2 * act, act // model, 0, 2, 1], accum * L)
    if cfg.family == "hybrid":
        _add(c, _dense_layers(cfg, L // cfg.attn_every, model, mb, seq, remat=False, sp=sp),
             accum)
    return _breakdown(*c)


def ssm_split_collectives(cfg, kind: str, rows: int, S: int, m: int, mode: str = "mixed"
                          ) -> dict:
    """The collectives of an ssm or hybrid serving step split over a model
    axis of m (`layers/mamba2.py`): per Mamba2 mixer whose heads split
    (`tensor.ssm_splits`) one all-reduce of its output (rows, S, D), or
    with the sequence split (`mode` "mixed" and S divides m) its input's
    all-gather and its output's reduce-scatter, and one all-reduce of the
    gated norm's fp32 sums of squares (rows, S, 1); a mixer that stays
    whole under the split gathers its input; the hybrid's shared block at
    each of its n_layers / attn_every sites as a dense layer, and the
    vocab's embedding and head, as `split_collectives` counts them. bf16
    compute."""
    import dataclasses

    from repro_torch.parallel import tensor
    sites = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    S1 = 1 if kind == "decode" else S
    sp = mode != "heads" and _sp(S1, m)
    out = split_collectives(dataclasses.replace(cfg, n_layers=sites), kind, rows, S, m, sp=sp)
    act = rows * S1 * cfg.d_model * 2
    mixers = cfg.n_layers * tensor.ssm_splits(cfg.ssm_heads, cfg.ssm_groups, m)
    if sp:
        out["all-gather"] += cfg.n_layers * act
        out["reduce-scatter"] += mixers * act // m
        out["all-reduce"] += mixers * rows * S1 * 4
        out["_num_ops"] += cfg.n_layers + 2 * mixers
        return out
    out["all-reduce"] += mixers * (act + rows * S1 * 4)
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
      probabilities' and the z-loss's sums in one (E + 1 fp32) and the
      assignments' (E fp32), two all-reduces; and where data > 1 the
      assignments of every data rank gathered for the experts' queues
      (`exclusive_sum`: data x E fp32), one all-gather;
    * unsplit, where the experts split over "model", the partial output
      (T, D) all-reduced once (remat's recompute stops before it:
      nothing after it is saved for the backward), and the gradients of
      the tokens that enter the buffer (T, D) and of the gates (T, K) fp32
      all-reduced once each (the two `copy_to`s);
    * with the sequence split (seq divides a model axis above 1), in the
      forward and the recompute, the tokens of every position all-gathered
      and the probabilities' and the z-loss's sum taken over the model
      group first (E + 1 fp32); in the backward the tokens' gradient
      reduce-scattered; where the experts split, the partial output
      reduce-scattered in the forward and its gradient all-gathered in
      the backward."""
    L, D, E, K = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.experts_per_token
    mb = batch // data // accum
    T = mb * seq
    sp = _sp(seq, model)
    c = _state_collectives(cfg, data=data, model=model, mb=mb, seq=seq, accum=accum, sp=sp)
    layer = _dense_layers(cfg, 1, model, mb, seq, remat=True, mlp=False, sp=sp)
    _add(layer, [2 * (2 * E + 1) * 4, 0, 0, 2 * 2, 0, 0])
    if data > 1:
        _add(layer, [0, 2 * data * E * 4, 0, 0, 2, 0])
    split = model > 1 and E % model == 0
    act = T * D * 2
    if sp:
        _add(layer, [2 * (E + 1) * 4, 2 * act, act // model, 2, 2, 1])
        if split:
            _add(layer, [0, act, act // model, 0, 1, 1])
    elif split:
        _add(layer, [2 * act + T * K * 4, 0, 0, 3, 0, 0])
    _add(c, layer, accum * L)
    return _breakdown(*c)
