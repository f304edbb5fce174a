"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one
NVIDIA H100: a data-driven harness (`core.py`), its yardstick (traffic,
counts, trace reduction, the plain reference and the check) and its
tests. Run a cell with `python3 gpubench/run.py --workload <cell> ...`."""
