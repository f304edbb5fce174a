"""Zamba2-7B-Instruct [hybrid] — 81 Mamba2 layers (2 groups, per-group
gated norm) and two alternating shared attention+MLP blocks on the
2·d_model input at 13 sites, each site with its own MLP adapter (rank
128) and linear (Zamba2's published layout, `models/zamba.py`).
[https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json;
arXiv:2411.15242]. Port-only: the reference package has no such config."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab=32000,
    act="gelu",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    rope_theta=1.0e4,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=2,
    conv_width=4,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
    ssm_group_norm=True,
)
