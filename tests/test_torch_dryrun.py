"""The port's dry run (`repro_torch.launch.dryrun`) on a fake world, on
the CPU: the counterpart of `test_dryrun_small.py`'s
`test_small_mesh_dryrun_subprocess`.

Each world is a process group of the `fake` backend opened in a
subprocess of its own (the group is process-wide), killed at its
timeout:

* a fake 2 x 4 (data, model) world, smoke llama3.2-3b: prefill and
  decode are `ok` with FLOPs and peak memory above 0, each rank running
  its 8 / 2 rows split over the model axis, their collectives those of
  `_tp_formula.split_collectives` and their fallbacks kv_heads' (the
  parameters' wk and wv, the cache's k and v); train is `ok` too, each
  rank training its 8 rows split over the model axis with its state cut
  over "data" (FSDP) and "model", its collectives those of
  `_tp_formula.train_collectives` and its fallbacks kv_heads' (wk and wv
  of the parameters, m and v);
* a fake 8 x 1 world: train is `ok`, and its collectives are what the
  FSDP step moves (`_tp_formula.train_collectives` at model 1): each
  layer's fp32 shards all-gathered in the forward and again in remat's
  recompute and reduce-scattered in the backward, the embedding's once
  each, the norm scales' gradients all-reduced, per microbatch the
  loss's two fp32 sums (the nll and the token count), and the global
  norm's one sum over "data";
* the command line on the 16 x 16 production world, full-width
  mamba2-2.7b on `meta` tensors: a record for each of its four cells, all
  `ok`, with 64 `ssd_scan` calls counted by formula in the prefill; the
  serve cells split over the model axis (its 80 heads by 16; its
  50,280-entry vocab whole, a recorded fallback), each counting fewer
  FLOPs a rank than the whole mixer did (`WHOLE_MIXER_FLOPS`); the train
  cell split over "model" with its state cut over "data" too (ROADMAP.md
  A.7c), under 74.5 GiB a rank, the vocab's fallbacks recorded, no
  kernel counted (training takes the SSD's chunked route) and its
  collectives those of `_tp_formula.ssm_train_collectives`;
* `make_production_mesh` over 256 and 512 fake ranks on `meta`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

from _tp_formula import split_collectives, ssm_train_collectives, train_collectives
from repro_torch import configs

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
# mamba2-2.7b's serve cells' FLOPs a rank on the 16 x 16 world while every
# rank ran its data group's whole mixer (the port's dry run before its
# split, ROADMAP.md A.7c)
WHOLE_MIXER_FLOPS = {"prefill_32k": 3.647e14, "decode_32k": 4.390e10, "long_500k": 5.487e9}


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
    cfg = configs.smoke("llama3.2-3b")
    for kind in ("prefill", "decode"):
        r = rec[f"2x4/{kind}"]
        assert r["ok"] and r["flops_per_device"] > 0 and r["peak_mem_per_device"] > 0, kind
        assert r["chips"] == 8 and r["mesh"] == "2x4" and r["rows_per_rank"] == 4
        # heads 4, ffn 96 and vocab 512 split over model 4; kv 1 does not, so
        # the cache goes by positions (parallel/tensor.py)
        assert r["collective_breakdown"] == split_collectives(cfg, kind, 4, 64, 4)
        assert r["fallbacks"] == [["kv_heads", 1, ["model"], None]] * 4
    train = rec["2x4/train"]
    assert train["ok"] and train["flops_per_device"] > 0 and train["rows_per_rank"] == 8
    assert train["collective_breakdown"] == train_collectives(cfg, data=2, model=4, batch=16,
                                                              seq=64, accum=2)
    assert train["fallbacks"] == [["kv_heads", 1, ["model"], None]] * 6
    r = rec["8x1/train"]
    assert r["ok"] and r["flops_per_device"] > 0 and r["peak_mem_per_device"] > 0
    want = train_collectives(cfg, data=8, model=1, batch=16, seq=64, accum=2)
    assert r["collective_breakdown"] == want and r["rows_per_rank"] == 2
    assert r["collective_bytes"] == sum(v for k, v in want.items() if not k.startswith("_"))


def test_dryrun_command_line_on_the_production_world(tmp_path):
    path = tmp_path / "dry.json"
    out = _run("", "-m", "repro_torch.launch.dryrun", "--mesh", "single_pod",
               "--arch", "mamba2-2.7b", "--out", str(path))
    assert "== 4/4 cells OK (0 new failures)" in out.stdout
    recs = {r["cell"]: r for r in json.loads(path.read_text())}
    assert set(recs) == {f"mamba2-2.7b/{s}"
                         for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
    train = recs["mamba2-2.7b/train_4k"]
    assert train["ok"] and train["mesh"] == "16x16" and train["rows_per_rank"] == 16
    assert 0 < train["peak_mem_per_device"] < 74.5 * 2**30 and train["kernels"] == {}
    assert ["vocab", 50280, ["model"], None] in train["fallbacks"]
    cfg = configs.get_config("mamba2-2.7b")
    assert train["collective_breakdown"] == ssm_train_collectives(
        cfg, data=16, model=16, batch=256, seq=4096, accum=8)
    pre = recs["mamba2-2.7b/prefill_32k"]
    assert pre["ok"] and pre["mesh"] == "16x16" and pre["chips"] == 256
    assert pre["rows_per_rank"] == 2 and pre["kernels"]["ssd_scan"]["calls"] == 64
    assert 0 < pre["useful_flops_ratio"] < 1
    for cell in ("decode_32k", "long_500k"):
        r = recs[f"mamba2-2.7b/{cell}"]
        assert r["ok"] and r["flops_per_device"] > 0 and r["kernels"] == {}
    for cell, whole in WHOLE_MIXER_FLOPS.items():
        r = recs[f"mamba2-2.7b/{cell}"]
        assert ["vocab", 50280, ["model"], None] in r["fallbacks"], cell
        assert 0 < r["flops_per_device"] < whole, cell


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
