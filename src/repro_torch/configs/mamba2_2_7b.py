"""Mamba2-2.7B [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    norm="rmsnorm",
    norm_eps=1e-5,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv_width=4,
)
