"""MusicGen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a stub: the batch carries precomputed frame embeddings
(`frame_embeds`, as `data.pipeline.make_batch` makes them), and the
backbone is the model. LayerNorm + GELU + sinusoidal positions.
[arXiv:2306.05284; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="dense",
    modality="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    act="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    pos="sin",
)
