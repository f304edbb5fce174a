"""Gemma-2B [dense] — GeGLU, head_dim=256, MQA (kv=1), tied + scaled
embeddings, (1+w) RMSNorm. [arXiv:2403.08295; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="geglu",
    norm="rmsnorm",
    norm_eps=1e-6,
    tie_embeddings=True,
    scale_embedding=True,
    norm_plus_one=True,
    rope_theta=1.0e4,
)
