"""Mamba2 SSD chunked scan: `ops` (wrapper), `ref` (plain versions),
`build` (nvcc + ctypes), `csrc/ssd_scan.cu` (the CUDA source)."""
