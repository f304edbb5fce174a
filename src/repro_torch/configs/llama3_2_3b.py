"""Llama-3.2-3B [dense] — GQA kv=8, tied embeddings, small llama3.
[hf:meta-llama/Llama-3.2-3B; unverified]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    act="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    rope_theta=5.0e5,
)
