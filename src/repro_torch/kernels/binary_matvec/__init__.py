"""Binary-activation matmul kernels (dense, packed and bit-plane) and the
whole-net bit-plane megakernel: `ops` (wrappers), `ref` (plain
versions), `build` (nvcc + ctypes), `csrc/binary_matvec.cu` (the CUDA
source)."""
