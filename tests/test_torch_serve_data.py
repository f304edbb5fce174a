"""LM serving split over a data axis above 1 (`serve/engine.py`), and the
serving launcher's meshes (`launch/serve.py`: `--multi-pod`, the
production branch), across gloo ranks on the CPU, held to one process
and to the JAX package's `Engine`.

Two worlds are started as processes (`tests/_serve_data_child.py`, which
imports torch and `repro_torch` only; its group comes from a `FileStore`
in a temporary directory; every spawn is killed at its timeout): 2 ranks
on a (2, 1) (data, model) mesh and 4 ranks on (2, 2), under the serving
rules (the batch over "data"). Each serves through `Engine`, at the
smoke size in fp32, 4 prompts of 8 tokens and 5 new tokens of
qwen1.5-4b, mamba2-2.7b, zamba2-2.7b, granite-moe-1b-a400m (whose
capacity is the global batch's) and qwen2-vl-2b (its extras cut by
rows); qwen1.5-4b's W8 tree (the reference's `quantize_params_for_serving`
at `min_size=0`); qwen1.5-4b at a batch of 3, which the data axis
does not divide; and qwen1.5-4b with an `eos_id`. Per world and case:

* every rank returns the same (B, 5) tokens, equal to one process's and
  to the reference's `Engine.generate` on the same weights;
* each rank's cache holds B / 2 rows (all 3 of the batch of 3, which is
  recorded as a `batch` fallback, as the reference's spec records it);
* with an `eos_id` that the last data rank's rows generate, every rank
  masks the same rows of the gathered tokens, as the reference does;
* granite-moe: each layer's routing of every token equal to one
  process's, the data ranks' tokens in rank order, and the pairs each
  call drops, summed over the data ranks, equal to one process's.

And the launcher: `--multi-pod` under a gloo world of 2 raises the
production mesh's world-size error; its (mesh, rules) on fake worlds of
256 and 512 ranks are the reference's (16 x 16 with the batch over
"data", 2 x 16 x 16 with the batch over ("pod", "data"), fsdp cleared),
and its batch spec the reference's; `launch.serve --smoke --w8` under a
(1, 2) gloo world prints the reference's summary line with one process's
tokens.
"""
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import base as jbase
from repro.parallel import sharding as jshd
from repro.quantized import apply as japply
from repro.serve import engine as jengine

from _gloo_world import spawn
from test_torch_tp import FakeMesh, _weights

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_serve_data_child.py")
B, P, NEW, MAX_LEN = 4, 8, 5, 24
ARCHS = ("qwen1.5-4b", "mamba2-2.7b", "zamba2-2.7b", "granite-moe-1b-a400m", "qwen2-vl-2b")
CASES = ([{"name": a, "arch": a, "weights": a, "batch": B} for a in ARCHS]
         + [{"name": "qwen1.5-4b-w8", "arch": "qwen1.5-4b", "weights": "qwen1.5-4b-w8",
             "batch": B},
            {"name": "qwen1.5-4b-b3", "arch": "qwen1.5-4b", "weights": "qwen1.5-4b", "batch": 3},
            {"name": "qwen1.5-4b-eos", "arch": "qwen1.5-4b", "weights": "qwen1.5-4b",
             "batch": B, "eos": "row 3's second token"}])
WORLDS = (2, 4)                  # (data 2, model 1), (data 2, model 2)
WORLD_CASES = [(w, c["name"]) for w in WORLDS for c in CASES]
MOE = "granite-moe-1b-a400m"


def _jcfg(arch: str):
    return dataclasses.replace(jconfigs.smoke(arch), compute_dtype="float32")


def serve_world(world: int, d: Path) -> dict:
    refs, trees = {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg = _jcfg(arch)
        keys, treedef, leaves = _weights(jcfg, seed=500 + i)
        jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
        batch = jpipeline.make_batch(jcfg, jbase.ShapeConfig("dp", P, B, "prefill"), 0)
        extras = {k: v for k, v in batch.items() if k not in ("tokens", "targets", "loss_mask")}
        trees[arch] = (jcfg, jp, batch["tokens"], extras)
        np.savez(d / f"{arch}.npz", prompts=batch["tokens"],
                 **{f"w/{k}": a for k, a in zip(keys, leaves)},
                 **{f"x/{k}": v for k, v in extras.items()})
        if arch == "qwen1.5-4b":
            jq = japply.quantize_params_for_serving(jcfg, jp, min_size=0)
            trees["qwen1.5-4b-w8"] = (jcfg, jq, batch["tokens"], extras)
            np.savez(d / "qwen1.5-4b-w8.npz", prompts=batch["tokens"],
                     **{f"w/{jax.tree_util.keystr(p)}": np.asarray(a)
                        for p, a in jax.tree_util.tree_flatten_with_path(jq)[0]})
    cases = []
    for case in CASES:
        jcfg, jp, prompts, extras = trees[case["weights"]]
        n = case["batch"]
        # eos: a token the last data rank's rows generate, so every rank
        # must stop rows it does not serve
        eos = int(refs[case["weights"]][3, 1]) if "eos" in case else -1
        eng = jengine.Engine(jcfg, jp, jengine.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                                                           eos_id=eos))
        refs[case["name"]] = eng.generate(prompts[:n], {k: jnp.asarray(v[:n])
                                                        for k, v in extras.items()} or None)
        cases.append(dict(case, eos=eos, over={}, max_len=MAX_LEN, new=NEW))
    (d / "cases.json").write_text(json.dumps(cases))
    return {"refs": refs, "ranks": spawn(CHILD, world, d)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    made: dict = {}

    def get(world: int) -> dict:
        if world not in made:
            made[world] = serve_world(world, tmp_path_factory.mktemp(f"dp{world}"))
        return made[world]

    return get


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_every_rank_returns_one_process_and_the_reference_tokens(worlds, world, name):
    w = worlds(world)
    want = np.asarray(w["refs"][name])
    if name.endswith("-eos"):       # rows stopped: row 3 and any that met the token
        assert (want[3, 1:] == want[3, 1]).all() and (want != w["refs"]["qwen1.5-4b"]).any()
    assert want.shape == (next(c["batch"] for c in CASES if c["name"] == name), NEW)
    for r in w["ranks"]:
        np.testing.assert_array_equal(r[f"{name}/plain/tokens"], want)
        np.testing.assert_array_equal(r[f"{name}/split/tokens"], want)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_a_rank_caches_its_rows(worlds, world, name):
    n = next(c["batch"] for c in CASES if c["name"] == name)
    for r in worlds(world)["ranks"]:
        rows = set(r[f"{name}/split/rows"].tolist())
        assert rows == ({n // 2} if n % 2 == 0 else {n}), rows
        assert set(r[f"{name}/plain/rows"].tolist()) == {n}
        # the batch's entry, and under a model split the cache leaves' too
        batch = [f for f in json.loads(str(r[f"{name}/fallbacks"])) if f[0] == "batch"]
        assert (batch == []) if n % 2 == 0 else \
            (batch and all(f == ["batch", n, ["data"], None] for f in batch))


@pytest.mark.parametrize("world", WORLDS)
def test_moe_routings_and_drops_are_the_global_batchs(worlds, world):
    """The data ranks' routings, in rank order, and their summed dropped
    pairs equal one process's at prefill and each decode step: the
    capacity and the experts' queues are the global batch's."""
    ranks = {int(r["data"]): r for r in worlds(world)["ranks"] if int(r["model"]) == 0}
    plain = ranks[0]
    calls = sum(k.startswith(f"{MOE}/plain/ids") for k in plain)
    assert calls == NEW * jconfigs.smoke(MOE).n_layers     # prefill and NEW - 1 steps
    split = [ranks[c] for c in sorted(ranks)]
    assert sum(k.startswith(f"{MOE}/split/ids") for k in split[0]) == calls
    for i in range(calls):
        whole = np.concatenate([r[f"{MOE}/split/ids{i}"] for r in split])
        np.testing.assert_array_equal(whole, plain[f"{MOE}/plain/ids{i}"])
    drops = sum(r[f"{MOE}/split/drops"] for r in split)
    np.testing.assert_array_equal(drops, plain[f"{MOE}/plain/drops"])
    assert plain[f"{MOE}/plain/drops"].sum() > 0          # the capacity binds somewhere


# -- the launcher ---------------------------------------------------------------

MESHES = r"""
import argparse, json
import torch.distributed as dist
from repro_torch.launch import dryrun, serve
from repro_torch.parallel import sharding as shd
out = {}
for world, multi_pod in ((256, False), (512, True)):
    dryrun.open_fake_world(world)
    args = argparse.Namespace(multi_pod=multi_pod, smoke=False)
    mesh, rules = serve.mesh_and_rules(args, world, "meta")
    with shd.use_mesh(mesh, rules):
        batch = list(shd.spec((128,), ("batch",)))
    out[world] = {"shape": mesh.shape, "rules": {k: list(v) for k, v in rules.items()},
                  "batch": batch}
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_launcher_mesh_and_rules_are_the_references_on_production_worlds():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", MESHES], env=env, capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for world, multi_pod, shape in (("256", False, {"data": 16, "model": 16}),
                                    ("512", True, {"pod": 2, "data": 16, "model": 16})):
        # the reference's launcher: `repro/launch/serve.py`'s production branch
        rules = ({} if multi_pod else {"batch": ("data",)}) | {"fsdp": ()}
        with jshd.use_mesh(FakeMesh(shape), rules):
            batch = jshd.spec((128,), ("batch",))
        assert got[world]["shape"] == shape
        assert got[world]["rules"] == {k: list(v) for k, v in rules.items()}
        assert got[world]["batch"] == [list(p) if isinstance(p, tuple) else p for p in batch]
    assert got["512"]["batch"] == [["pod", "data"]] and got["256"]["batch"] == ["data"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, args: list, d: Path) -> list:
    """`python -m repro_torch.launch.serve ARGS` as `world` gloo ranks, as
    torchrun starts them (a rendezvous on this host); (exit code, output)
    of each rank."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
               "WORLD_SIZE": str(world), "RANK": str(r), "LOCAL_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        log = open(d / f"launch{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *args],
                                       env=env, stdout=log, stderr=subprocess.STDOUT,
                                       cwd=d), log))
    out = []
    for r, (p, log) in enumerate(procs):
        try:
            p.wait(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        out.append((p.returncode, (d / f"launch{r}.log").read_text()))
    return out


def test_launcher_multi_pod_on_a_small_world_raises_the_mesh_error(tmp_path):
    ranks = _launch(2, ["--arch", "qwen1.5-4b", "--smoke", "--multi-pod", "--device", "cpu"],
                    tmp_path)
    for code, text in ranks:
        assert code != 0
        assert ("the production mesh {'pod': 2, 'data': 16, 'model': 16} needs 512 ranks; "
                "this world has 2") in text


def test_launcher_serves_w8_split_over_two_ranks(tmp_path, capsys):
    from repro_torch.launch import serve
    args = ["--arch", "qwen1.5-4b", "--smoke", "--w8", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--new-tokens", "3"]
    one = serve.main(args)
    capsys.readouterr()
    ranks = _launch(2, args, tmp_path)
    assert [code for code, _ in ranks] == [0, 0], ranks[0][1][-3000:] + ranks[1][1][-3000:]
    line = re.compile(r"^generated 6 tokens in \d+\.\d\ds \(\d+\.\d tok/s\); sample: (\[.*\])$",
                      re.M)
    got = line.search(ranks[0][1])
    assert got and json.loads(got.group(1)) == one[0][:12].tolist()
    assert not line.search(ranks[1][1])                     # rank 0 alone prints it
    assert all("serving W8-specialized checkpoint" in text for _, text in ranks)
