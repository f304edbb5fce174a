"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic,
limits, driver and metrics are found by name from `BENCHMARK.json`
(`gpubench/core.py`). The last line of standard output is the result as
one JSON object; the numbers the check compared, each with its limit,
are the last lines of standard error. A run that finds fewer CUDA
devices than the cell asks for exits non-zero and prints no result.

Every build and kernel cache of the program is kept under the
checkout's `build/` directory, at fixed paths.
"""
import time

_T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from gpubench import core
    return core.main(args, _T_START)


if __name__ == "__main__":
    sys.exit(main())
