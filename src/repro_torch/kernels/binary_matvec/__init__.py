"""Bit-plane popcount kernels: `ops` (wrappers), `ref` (plain versions),
`build` (nvcc + ctypes), `csrc/binary_matvec.cu` (the CUDA source)."""
