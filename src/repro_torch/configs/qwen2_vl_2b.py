"""Qwen2-VL-2B [vlm] — M-RoPE; the dynamic-resolution vision frontend is a
stub: the batch carries precomputed patch embeddings (`pixel_embeds`,
`pixel_mask`, as `data.pipeline.make_batch` makes them), and the
backbone is the model. [arXiv:2409.12191; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="dense",
    modality="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    act="swiglu",
    norm="rmsnorm",
    norm_eps=1e-6,
    qkv_bias=True,
    tie_embeddings=True,
    pos="mrope",
    mrope_sections=(16, 24, 24),   # t/h/w half-dim sections, sum = hd//2
    rope_theta=1.0e6,
)
