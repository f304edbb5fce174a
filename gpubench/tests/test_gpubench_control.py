"""On the card: the control comes out not correct and the program correct,
at each cell's own size, on one seed each (`tools/control.py`: the
cell's own driver with a window of one cycle, and the control read on
the requests that run's check compared).

The control is the reference in fp8 put in the program's place; its
widest gap must pass the cell's limit, and the program's must not. Each
case takes one to two minutes on an H100 (set-up, one cycle of the mix,
the reference three times over the check's sample). Run on the chip with

    python -m pytest -q -m cuda gpubench/tests/test_gpubench_control.py
"""
import json
from pathlib import Path

import pytest
import torch

from gpubench import core

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _load_tool():
    return core.load_module(ROOT / "gpubench" / "tools" / "control.py")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_the_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limit = json.loads((ROOT / "gpubench" / "limits" / f"{cell}.json").read_text())["gap"]
    seed = 2 ** 31 + 977
    (rec,) = list(_load_tool().readings(cell, [seed], [seed]))
    assert rec["correct"] and rec["gap"] <= limit < rec["control_gap"], rec
