"""W8A8 int8 matmul with a fused dequantizing epilogue: `ops` (wrappers),
`ref` (plain versions), `build` (nvcc + ctypes), `csrc/quant_matmul.cu`
(the CUDA source)."""
