"""Roofline terms of one (arch x shape x mesh) cell, per rank.

Counterpart of `repro/launch/roofline.py`. Three terms in seconds:

    compute    = flops_per_device / HW["peak_bf16_flops"]
    memory     = bytes_per_device / HW["hbm_bw"]
    collective = collective_bytes / HW["nvlink_bw"]

over the port's `launch/mesh.py` `HW` (NVIDIA H100 80GB HBM3 at 700 W:
989e12 bf16 FLOP/s dense, 3.35e12 B/s HBM). The collective term divides
by NVLink's 450e9 B/s a direction where the reference divides by the
TPU's ICI link rate. The per-rank counts come from the port's counting
mode (`launch/cost.py`), not from XLA: `collective_stats` totals the
collectives that a `cost.Counter` saw, by the reference's kinds, each
op's OUTPUT bytes, as the reference counts them in HLO text.

`model_flops`, `active_param_count` and the inner-scan corrections are
the reference's arithmetic on the config, over the port's
`api.abstract_params` and `base.count_params`. The port's layer loops
are Python loops and its counter sees every flash block and SSD chunk,
so the corrections are not added to a count here: they are the
reference's yardstick, and `ssd_forward` is the formula by which the
`ssd_scan` kernel reports its work to the counter.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.launch.mesh import HW

__all__ = ["KINDS", "collective_stats", "Roofline", "model_flops", "active_param_count",
           "write_report", "Q_BLK", "K_BLK", "SSD_CHUNK", "flash_correction", "ssd_forward",
           "ssd_correction", "inner_scan_corrections"]

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def collective_stats(ops) -> dict:
    """Per-kind byte totals of (kind, output bytes) pairs, the collectives
    a `cost.Counter` recorded (`Counter.collective_ops`), with `_num_ops`."""
    out: dict[str, int] = {}
    count = 0
    for kind, nbytes in ops:
        if kind not in KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] = out.get(kind, 0) + int(nbytes)
        count += 1
    out["_num_ops"] = count
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collective_breakdown: dict
    model_flops: float             # 6*N*D (dense) / 6*N_active*D (moe)
    peak_mem_per_device: float     # bytes (cost.Counter's peak)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / HW["peak_bf16_flops"]

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HW["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / HW["nvlink_bw"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops x chips): how much counted compute
        is 'useful'. Catches remat recompute and replicated work."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / max(all terms)."""
        t_useful = (self.model_flops / self.chips) / HW["peak_bf16_flops"]
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / bound if bound else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, shape) -> float:
    """6*N*D for training, 2*N*D for inference forward, where N = active
    params (excluding embeddings' gather) and D = tokens processed."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def active_param_count(cfg) -> float:
    """Parameters touched per token (MoE counts top-k experts only),
    excluding the embedding table (its gather is O(d), not O(vocab*d)) but
    including the LM head matmul."""
    from repro_torch.models import api
    from repro_torch.models.base import count_params
    tree = api.abstract_params(cfg)
    total = count_params(tree)
    emb = cfg.vocab * cfg.d_model
    total -= emb                       # embedding gather
    if cfg.tie_embeddings:
        total += emb                   # tied head still does the matmul
    if cfg.family == "moe":
        moe_params = tree["layers"]["moe"]
        moe_total = count_params({k: v for k, v in moe_params.items()
                                  if k != "router"})
        active = moe_total * cfg.experts_per_token / cfg.n_experts
        total = total - moe_total + active
    return float(total)


def write_report(records: list[dict], path: str):
    with open(path, "w") as f:
        json.dump(records, f, indent=1, default=float)


# ---------------------------------------------------------------------------
# The reference's analytic totals of the per-layer inner scans (flash
# blocks, SSD chunks). Conventions: bf16 activations (2B); train includes
# full-remat recompute (fwd happens twice) and the two-pass flash backward.
# ---------------------------------------------------------------------------

Q_BLK, K_BLK = 512, 1024          # must match layers/flash.py defaults
SSD_CHUNK = 128                    # must match layers/mamba2.py default


def flash_correction(cfg, *, batch: int, seq: int, kind: str) -> dict:
    """Per-STEP flash totals for one attention layer x n_attn_layers."""
    if cfg.family in ("dense", "moe"):
        n_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    else:
        return {"flops": 0.0, "bytes": 0.0}
    from repro_torch.layers.attention import FLASH_MIN_SEQ
    if seq < FLASH_MIN_SEQ or kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}

    B, S, H, KV, hd = batch, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    U = B * H * S * S * hd           # one qk-sized einsum = 2U flops
    nq, nk = S // min(Q_BLK, S), S // min(K_BLK, S)
    # forward: qk + pv = 4U ; backward pass1 (p,dv,dp,dk) = 8U ;
    # pass2 (p,dp,dq) = 6U ; remat recompute of fwd = 4U
    fwd, bwd, rematf = 4 * U, 14 * U, 4 * U
    flops = fwd + (bwd + rematf if kind == "train" else 0.0)
    qbytes = 2 * B * H * S * hd
    kvbytes = 2 * B * KV * S * hd * 2
    by_fwd = qbytes * 2 + nq * kvbytes          # q,out once; k/v per q-block
    by_bwd = (nk * qbytes * 2 + kvbytes * 2     # pass1: q,do per kv-blk
              + nq * kvbytes + qbytes * 2)      # pass2: k/v per q-blk; dq
    bytes_ = by_fwd + ((by_bwd + by_fwd) if kind == "train" else 0.0)
    return {"flops": float(flops * n_attn), "bytes": float(bytes_ * n_attn)}


def ssd_forward(B: int, S: int, H: int, P: int, N: int, G: int, Q: int) -> tuple:
    """(flops, bytes) of one layer's SSD chunk scan forward, the
    reference's formula: scores 2BSQHN + y_intra 2BSQHP + (y_inter +
    states) 4BSHNP, and the inputs and outputs in 2-byte elements."""
    fwd = 2 * B * S * H * (Q * N + Q * P + 2 * N * P) + 3 * B * S * Q * H
    io = 4 * B * S * (H * P + H + 2 * G * N) * 2
    return fwd, io


def ssd_correction(cfg, *, batch: int, seq: int, kind: str) -> dict:
    """Per-STEP SSD chunk-scan totals across mamba layers."""
    if cfg.family not in ("ssm", "hybrid") or kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    fwd, io = ssd_forward(batch, seq, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                          cfg.ssm_groups, min(SSD_CHUNK, seq))
    flops = fwd * (4.0 if kind == "train" else 1.0)   # bwd 2x + recompute 1x
    bytes_ = io * (4.0 if kind == "train" else 1.0)
    return {"flops": float(flops * cfg.n_layers), "bytes": float(bytes_ * cfg.n_layers)}


def inner_scan_corrections(cfg, *, batch: int, seq: int, kind: str) -> dict:
    f = flash_correction(cfg, batch=batch, seq=seq, kind=kind)
    s = ssd_correction(cfg, batch=batch, seq=seq, kind=kind)
    return {"flops": f["flops"] + s["flops"], "bytes": f["bytes"] + s["bytes"]}
