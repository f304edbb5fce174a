"""`BENCHMARK.json` and the harness's files: the contract's names and
limits, every `moves` reported where its metric is, nothing that imports
JAX or the JAX package, a reference that imports nothing of the program,
and a cell made only of new files that the harness finds unedited."""
import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gpubench import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & FORBIDDEN
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
    code = ("import sys; import gpubench.reference.mamba2, gpubench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(ROOT), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert "repro" in core.forbidden_modules()


def test_manifest_keeps_to_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert not any(p.startswith("/") or ".." in p.split("/") for p in m["paths"] + m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    cells, configs = m["workloads"], m["configs"]
    assert 1 <= len(configs) <= 24 and 1 <= len(cells) <= 24
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells)
        held = json.loads((ROOT / c["file"]).read_text())
        assert sorted(held["reduced"]) == sorted(c["reduced"])
    assert len({c["file"] for c in configs}) == len(configs)
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in {c["name"] for c in configs}
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    metrics = m["end_to_end"] + m["per_layer"]
    names = [x["name"] for x in metrics]
    assert len(set(names)) == len(names)
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({c["name"] for c in configs}) == len(configs)
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(x["layer"])
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher") and x["source"] in SOURCES
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move():
    m = _manifest()
    e2e = {x["name"] for x in m["end_to_end"]}
    for w in m["workloads"]:
        ends = {x["name"] for x in core.cell_metrics(m, w["name"], "end_to_end")}
        assert "setup_s" in ends and len(ends) >= 2
        assert core.cell_metrics(m, w["name"], "per_layer")
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        for cell in x.get("workloads", [w["name"] for w in m["workloads"]]):
            ends = {y["name"] for y in core.cell_metrics(m, cell, "end_to_end")}
            assert x["moves"] in ends, (x["name"], cell)


def test_every_piece_is_a_file_found_by_name():
    m = _manifest()
    for w in m["workloads"]:
        ctx = core.context(m, w["name"], 1, 1.0, False, torch.device("cpu"), time.time())
        assert (BENCH / "drivers" / f"{ctx.config['driver']}.py").is_file()
        assert callable(ctx.reference.logits) and callable(ctx.reference.prefill_flops)
        assert "gap" in ctx.limits
    for x in m["end_to_end"] + m["per_layer"]:
        assert hasattr(core.load_module(BENCH / "metrics" / f"{x['name']}.py"), "read")


def test_a_new_cell_of_new_files_is_found_without_editing_any(tmp_path):
    """A copy of the checkout gains a configuration with a reference module
    of its own, a traffic mix, a limits file and a per-layer metric's
    reader, and entries in BENCHMARK.json: the harness runs the new cell
    (tiny, on the CPU) through the new reference and reads the new metric,
    and no file that was there changed."""
    from repro_torch import configs
    import dataclasses
    shutil.copytree(BENCH, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "gpubench").rglob("*") if p.is_file()}
    m = _manifest()
    new = tmp_path / "gpubench"
    config = json.loads((BENCH / "configs" / "mamba2-2.7b.json").read_text())
    small = dataclasses.asdict(dataclasses.replace(configs.smoke("mamba2-2.7b"),
                                                   tie_embeddings=True))
    (new / "configs" / "tiny-ssm.json").write_text(json.dumps(
        dict(config, name="tiny-ssm", reference="tiny_ssm", arch=small)))
    (new / "reference" / "tiny_ssm.py").write_text(
        (BENCH / "reference" / "mamba2.py").read_text()
        + "\nCALLS = []\n_logits = logits\n\n\ndef logits(*a, **k):\n"
        "    CALLS.append(1)\n    return _logits(*a, **k)\n")
    (new / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "rows": 2, "prompt_lengths": [16, 48],
         "new_tokens": 3, "check_requests": 4}))
    (new / "limits" / "tiny-ssm.tiny_mix.json").write_text(
        (BENCH / "limits" / "mamba2-2.7b.long_prompt.json").read_text())
    (new / "metrics" / "batches_in_window.py").write_text(
        "def read(run):\n    return float(len(run.batches))\n")
    m["configs"].append({"name": "tiny-ssm", "source": "https://arxiv.org/abs/2405.21060",
                         "file": "gpubench/configs/tiny-ssm.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "tiny-ssm.tiny_mix", "config": "tiny-ssm",
                           "traffic": "tiny_mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "batches_in_window", "unit": "batches", "better": "higher",
                           "source": "host_clock", "layer": "serving engine",
                           "moves": "total_tokens_per_s",
                           "workloads": ["tiny-ssm.tiny_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    ctx = core.context(m, "tiny-ssm.tiny_mix", 5, 0.1, True, torch.device("cpu"),
                       time.time(), root=tmp_path)
    run, metrics = core.execute(m, ctx)
    assert run.correct and metrics["batches_in_window"]["value"] == len(run.batches) >= 2
    assert ctx.reference.CALLS
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
    assert not (BENCH / "traffic" / "tiny_mix.json").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in _manifest()["workloads"]])
def test_traffic_runs_on_the_port_without_a_failing_operation(cell):
    """Every prompt and its answer fit the configuration's context, where
    it states one."""
    m = _manifest()
    ctx = core.context(m, cell, 1, 1.0, False, torch.device("cpu"), time.time())
    for length in ctx.traffic["prompt_lengths"]:
        assert length >= 1
        limit = ctx.config.get("context_length")
        if limit:
            assert length + ctx.traffic["new_tokens"] <= limit
