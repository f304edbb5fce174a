"""The port's dry run (`repro_torch.launch.dryrun`) on a fake world, on
the CPU: the counterpart of `test_dryrun_small.py`'s
`test_small_mesh_dryrun_subprocess`.

Each world is a process group of the `fake` backend opened in a
subprocess of its own (the group is process-wide), killed at its
timeout:

* a fake 2 x 4 (data, model) world, smoke llama3.2-3b: prefill and
  decode are `ok` with FLOPs and peak memory above 0, each rank running
  its 8 / 2 rows; train is refused with the port's item-7 error (a
  model axis above 1);
* a fake 8 x 1 world: train is `ok`, and its all-reduce bytes are what
  the data-parallel step reduces: every fp32 gradient once (4 bytes a
  parameter), and per microbatch the loss's two fp32 sums (the nll and
  the token count), so 4 N + 8 accum bytes in N + 2 accum ops;
* the command line on the 16 x 16 production world, full-width
  mamba2-2.7b on `meta` tensors: a record for each of its four cells,
  train refused, the others `ok` with 64 `ssd_scan` calls counted by
  formula in the prefill;
* `make_production_mesh` over 256 and 512 fake ranks on `meta`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def _run(script: str, *args) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, *(["-c", script] if script else []), *args],
                         env=env, capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out


SMALL = r"""
import json
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models.base import ShapeConfig, count_params
from repro_torch.train import step

dryrun.open_fake_world(8)
cfg = configs.smoke("llama3.2-3b")
out = {"n_params": count_params(step.abstract_state(cfg)["params"])}
for name, mesh_shape in (("2x4", (2, 4)), ("8x1", (8, 1))):
    mesh = make_mesh_compat(mesh_shape, ("data", "model"), device="meta")
    for shape in (ShapeConfig("t", 64, 16, "train", accum=2),
                  ShapeConfig("p", 64, 8, "prefill"), ShapeConfig("d", 64, 8, "decode")):
        try:
            record, meta = dryrun.run_cell(cfg, shape, mesh, verbose=False)
            out[f"{name}/{shape.kind}"] = {"ok": True, **record.as_dict(), **meta}
        except NotImplementedError as e:
            out[f"{name}/{shape.kind}"] = {"ok": False, "error": str(e)}
print(json.dumps(out, default=float))
"""


def test_small_mesh_dryrun_subprocess():
    rec = json.loads(_run(SMALL).stdout.strip().splitlines()[-1])
    for kind in ("prefill", "decode"):
        r = rec[f"2x4/{kind}"]
        assert r["ok"] and r["flops_per_device"] > 0 and r["peak_mem_per_device"] > 0, kind
        assert r["chips"] == 8 and r["mesh"] == "2x4" and r["rows_per_rank"] == 4
        assert r["collective_breakdown"]["_num_ops"] == 0
    train = rec["2x4/train"]
    assert not train["ok"]
    assert "model axis 4" in train["error"] and "(ROADMAP.md, A.7)" in train["error"]
    r = rec["8x1/train"]
    assert r["ok"] and r["flops_per_device"] > 0 and r["peak_mem_per_device"] > 0
    accum = 2
    assert r["collective_breakdown"] == {
        "all-reduce": 4 * rec["n_params"] + 8 * accum, "all-gather": 0, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "_num_ops": r["collective_breakdown"]["_num_ops"]}
    assert r["collective_bytes"] == 4 * rec["n_params"] + 8 * accum


def test_dryrun_command_line_on_the_production_world(tmp_path):
    path = tmp_path / "dry.json"
    out = _run("", "-m", "repro_torch.launch.dryrun", "--mesh", "single_pod",
               "--arch", "mamba2-2.7b", "--out", str(path))
    assert "== 3/4 cells OK (0 new failures)" in out.stdout
    recs = {r["cell"]: r for r in json.loads(path.read_text())}
    assert set(recs) == {f"mamba2-2.7b/{s}"
                         for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
    assert not recs["mamba2-2.7b/train_4k"]["ok"]
    assert "NotImplementedError" in recs["mamba2-2.7b/train_4k"]["error"]
    pre = recs["mamba2-2.7b/prefill_32k"]
    assert pre["ok"] and pre["mesh"] == "16x16" and pre["chips"] == 256
    assert pre["rows_per_rank"] == 2 and pre["kernels"]["ssd_scan"]["calls"] == 64
    assert 0 < pre["useful_flops_ratio"] < 1
    for cell in ("decode_32k", "long_500k"):
        r = recs[f"mamba2-2.7b/{cell}"]
        assert r["ok"] and r["flops_per_device"] > 0 and r["kernels"] == {}


PROD = r"""
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
for world, multi in ((256, False), (512, True)):
    dryrun.open_fake_world(world)
    mesh = make_production_mesh(multi_pod=multi, device="meta")
    print(mesh.shape, mesh.device_type, dist.get_world_size(mesh.group(("pod", "data")
          if multi else "data")), mesh.coordinate("model"))
    dist.destroy_process_group()
"""


def test_production_meshes_over_fake_worlds():
    lines = _run(PROD).stdout.strip().splitlines()[-2:]
    assert lines == ["{'data': 16, 'model': 16} meta 16 0",
                     "{'pod': 2, 'data': 16, 'model': 16} meta 32 0"]
