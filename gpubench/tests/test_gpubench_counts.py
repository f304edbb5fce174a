"""The yardstick's formulas against counts by hand at small shapes, and
B7's bound at PERF.md's shape. The counts (`counts.py`, and the
reference's `prefill_flops`) read nothing of the program's counting mode
(`launch/cost.py`)."""
import ast
from pathlib import Path

import pytest

from gpubench import counts
from gpubench.reference import mamba2

BENCH = Path(__file__).resolve().parents[1]


def test_ssd_forward_by_hand():
    # B=1, S=2, H=1, P=1, N=1, G=1, Q=2: 2·2·(2 + 2 + 2) + 3·2·2 operations;
    # x 4 B, dt 4, a 4, b and c 8, y 4, the final state 4
    assert counts.ssd_forward(1, 2, 1, 1, 1, 1, Q=2) == (36, 28)


def test_b7_bound_at_the_kernel_table_shape():
    arch = {"d_model": 2560, "ssm_expand": 2, "ssm_headdim": 64, "ssm_state": 128,
            "ssm_groups": 1}
    # PERF.md's B7 row: bf16 B=4, L=512, H=80, P=64, N=128: 0.0161 ms by bytes
    assert counts.ssd_bound_s(arch, 4, 512) * 1e3 == pytest.approx(0.01606, abs=5e-5)
    ops, nbytes = counts.ssd_forward(4, 512, 80, 64, 128, 1)
    assert nbytes / counts.HBM_BYTES_PER_S > ops / counts.PEAK_BF16_FLOPS


def test_prefill_flops_by_hand_ssm():
    arch = {"family": "ssm", "n_layers": 2, "d_model": 4, "ssm_expand": 2, "ssm_headdim": 4,
            "ssm_state": 2, "ssm_groups": 1, "conv_width": 4, "vocab": 10}
    # d_inner 8, H 2, conv channels 8 + 4 = 12; in_proj 4 x (16 + 4 + 2) = 88,
    # conv 4 x 12 = 48, out_proj 8 x 4 = 32: 168 weights a mixer
    rows, length = 3, 5
    mixers = 2 * rows * length * 2 * 168
    ssd = 2 * counts.ssd_forward(rows, length, 2, 4, 2, 1)[0]
    head = 2 * rows * 4 * 10
    assert mamba2.prefill_flops(arch, rows, length) == mixers + ssd + head


def test_prefill_flops_at_the_configuration_counts_every_weight_once():
    """At mamba2-2.7b's sizes the matrix-product weights a token passes
    are the mixers' in_proj, conv and out_proj (the norms and vectors
    excepted): 2.57 B, which with the tied embedding's 0.13 B makes the
    published 2.7 B."""
    import json
    arch = json.loads((BENCH / "configs" / "mamba2-2.7b.json").read_text())["arch"]
    per_token = (mamba2.prefill_flops(arch, 1, 2) - mamba2.prefill_flops(arch, 1, 1)
                 - arch["n_layers"] * (counts.ssd_forward(1, 2, 80, 64, 128, 1)[0]
                                       - counts.ssd_forward(1, 1, 80, 64, 128, 1)[0]))
    d, di, n = 2560, 5120, 128
    weights = 64 * (d * (2 * di + 2 * n + 80) + 4 * (di + 2 * n) + di * d)
    assert per_token == 2 * weights
    assert 2.69e9 < weights + 50288 * d < 2.71e9


def test_counts_read_no_counter_of_the_program():
    for path in (BENCH / "counts.py", BENCH / "reference" / "mamba2.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module])
                assert not any(m and m.split(".")[0] in ("repro_torch", "repro") for m in mods)
    for name in ("prefill_mfu.py", "ssd_scan_roofline.py"):
        text = (BENCH / "metrics" / name).read_text()
        assert "repro_torch" not in text and "cost" not in text.replace("counts", "")
