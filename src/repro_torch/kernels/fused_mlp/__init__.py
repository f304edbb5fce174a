"""The paper's two-layer net in one kernel launch: `ops` (wrapper), `ref`
(plain version), `build` (nvcc + ctypes), `csrc/fused_mlp.cu` (the CUDA
source)."""
