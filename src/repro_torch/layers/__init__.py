"""The layers of the port's LM stack: normalization, weight access,
embedding, rotary positions, the gated MLPs, attention with its KV cache,
flash attention, and the Mamba2 mixer."""
