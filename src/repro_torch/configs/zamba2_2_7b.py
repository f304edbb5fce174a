"""Zamba2-2.7B [hybrid] — Mamba2 backbone + shared attention blocks
(54 mamba layers, shared attn+MLP applied every 6). [arXiv:2411.15242; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    act="gelu",
    norm="rmsnorm",
    norm_eps=1e-5,
    rope_theta=1.0e4,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv_width=4,
    attn_every=6,
)
