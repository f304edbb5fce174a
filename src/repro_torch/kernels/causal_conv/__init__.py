"""Mamba2's prefill causal conv with its bias and SiLU: `ops` (wrapper),
`ref` (plain version), `build` (nvcc + ctypes), `csrc/causal_conv.cu` (the
CUDA source)."""
