"""The ssm and hybrid families trained under a model axis above 1, with
FSDP over "data" (`layers/mamba2.py`, `parallel/{tensor,fsdp}.py`,
`train/step.py`), across gloo ranks on the CPU, held to the JAX package's
one-process train step and to the port's.

Four worlds are started as processes (`tests/_tp_train_child.py`, which
imports torch and `repro_torch` only; its group comes from a `FileStore`
in a temporary directory; every spawn is killed at its timeout): (data,
model) = (2, 1), FSDP alone, which these families take under model = 1;
(1, 2); (2, 2); and (1, 4), under the reference trainer's rules (fsdp
over "data"). Each trains, at the smoke size in fp32, mamba2-2.7b (8
heads, 1 group, shared by every model rank) and zamba2-2.7b (its shared
block's heads, kv heads and ffn split too), 2 steps of 4 x 16 tokens in 2
microbatches (`trainer.run` resumed from the case's initial state,
remat="full"). Configs derived from mamba2's test the B and C sums: 2
groups under (1, 2), (2, 2) and (1, 4) (one a rank under 2; under 4 each
shared by two ranks, the sums of the two groups kept apart), 4 groups and
6 heads under (1, 4) (one group a rank, nothing shared; 6 heads do not
divide 4, so the mixer stays whole on every rank, a recorded fallback).
Every leaf of the initial state is drawn with numpy from a seed at the
reference's init scales (biases and norm scales moved off 0 and 1), m, v
and the step zero. Per world and case:

* losses within 1e-6 relative of the reference's two steps
  (`repro.train.step`, in `tests/_pinned_parent.py`'s pinned subprocess
  on one thread), and the whole parameters gathered from the ranks within
  1e-6 of their largest magnitude wherever the reference's gradient
  stayed above EPS_REGIME in both steps, within 2 lr elsewhere
  (test_torch_tp_train.py's criterion; at least SHARE of the elements
  held at 1e-6: the rest are mostly embedding rows of tokens absent from
  the batches, whose gradient is zero);
* the same against the port's one-process steps, whose losses and grad
  norms the ranks' equal within 1e-6 relative, and every leaf's gradient
  on the first batch, gathered from the ranks (after the step's sums of
  the per-head vectors and of the shared B and C), within 1e-6 of the
  largest |g| of one process's, or, for a leaf where the port's one
  process and the reference's step differ by more, within `SPREAD` times
  that spread: the embedding's gradient, the largest leaf, sums every
  position's and, in zamba2, every site's share, and two fp32
  computations of it in one process differ by about 1e-6 to 2e-6 of the
  largest |g| here (zamba2's: the port's against the reference's 1.1e-6,
  the port's against a float64 one 1.75e-6, CPU run), as far as the
  split's does from one process (up to 2.4e-6, 2.2 x that spread);
* every rank's initial shards bitwise equal to their slices: `in_proj`,
  `conv_w` and `conv_b` head-aligned over "model" (test_torch_tp_ssm.py's
  `_head_slice`) and the spec's slice over "data"; every other leaf the
  slice of the reference's `sharding.spec` under the training rules; its
  final shards the same slices of the whole result; the fallbacks the
  reference's, and the port's own ("ssm_heads", 6, ...) for each mixer
  leaf that stays whole; the checkpoint written at step 2 (rank 0, from
  every rank's shards) equal to the whole result;
* the copies that several ranks hold bitwise equal across them after the
  steps: the per-head vectors on every rank, and a shared group's B and C
  columns and conv channels on the ranks of one data coordinate whose
  heads use it;
* `global_norm` of the initial parameters' shards, each leaf's squares
  summed over the axes that cut it and a shared B or C column counted
  once, within 1e-6 of the whole tree's.

And on a fake world of 4 ranks on `meta` (a subprocess: the group is
process-wide), mamba2 and zamba2 smoke under (2, 2): the counted
argument bytes of a train step equal its state shards' and its inputs'
(and the scalars the step makes), its collectives equal a formula
(`tests/_tp_formula.ssm_train_collectives`), and its counts lie on one
line in the layer count through the dry run's two analysis depths.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _tp_formula import ssm_train_collectives
from test_torch_tp_ssm import HEAD_ALIGNED, _head_slice, _mixer_leaf, _splits
from test_torch_tp_train import LR, SHARE, _close, _jcfg, _slice, _specs, train_worlds

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
BASE = {"seq": 16, "batch": 4, "accum": 2, "lr": LR, "data_seed": 5}
MAMBA = {"name": "mamba2-2.7b", "arch": "mamba2-2.7b", "over": {}}
ZAMBA = {"name": "zamba2-2.7b", "arch": "zamba2-2.7b", "over": {}}
G2 = {"name": "mamba2-g2", "arch": "mamba2-2.7b", "over": {"ssm_groups": 2}}
G4 = {"name": "mamba2-g4", "arch": "mamba2-2.7b", "over": {"ssm_groups": 4}}
H6 = {"name": "mamba2-h6", "arch": "mamba2-2.7b", "over": {"d_model": 48}}
WORLDS = {(2, 1): [MAMBA, ZAMBA], (1, 2): [MAMBA, ZAMBA, G2], (2, 2): [MAMBA, ZAMBA, G2],
          (1, 4): [MAMBA, ZAMBA, G2, G4, H6]}
ALL = {c["name"]: dict(BASE, **c) for cases in WORLDS.values() for c in cases}
WORLD_CASES = [(w, c["name"]) for w, cases in WORLDS.items() for c in cases]
SPREAD = 3          # x the one-process spread that bounds a gradient (module doc)
# the whole leaves the mixer indexes at its heads
HEAD_VECTORS = ("a_log", "dt_bias", "d_skip", "norm_scale")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's steps of every case and every world's ranks; world
    -> results."""
    return train_worlds(tmp_path_factory.mktemp("tp_ssm_train"), ALL, WORLDS, seed=400)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_steps_match_the_reference(run, world, name):
    lead, ref = run["ranks"][world][0], run["ref"][name]
    for r in run["ranks"][world]:
        np.testing.assert_allclose(r[f"{name}/loss"], ref["loss"], rtol=1e-6, atol=0)
    assert _close(lead, f"{name}/whole", ref["params"], ref["gmin"]) >= SHARE


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_steps_match_one_process(run, world, name):
    lead, ref = run["ranks"][world][0], run["ref"][name]
    plain = {k: lead[f"{name}/plain/{k}"] for k in ref["params"]}
    for r in run["ranks"][world]:
        np.testing.assert_allclose(r[f"{name}/loss"], lead[f"{name}/plain/loss"], rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(r[f"{name}/gnorm"], lead[f"{name}/plain/gnorm"], rtol=1e-6,
                                   atol=0)
    _close(lead, f"{name}/whole", plain, ref["gmin"])
    grads = {k: lead[f"{name}/grad/plain/{k}"] for k in ref["params"]}
    scale = max(np.abs(v).max() for v in grads.values())
    for k, v in grads.items():
        bound = max(1e-6 * scale, SPREAD * np.abs(ref["grad0"][k] - v).max())
        assert np.abs(lead[f"{name}/grad/whole/{k}"] - v).max() <= bound, k


def _want(whole: np.ndarray, key: str, spec, coord: dict, mesh: dict, jcfg) -> np.ndarray:
    """A rank's slice of a whole leaf: over "data" the spec's; over
    "model" a mixer leaf's head-aligned cut (or whole, where the mixer
    does not split), every other leaf the spec's."""
    leaf, m = _mixer_leaf(key), mesh["model"]
    split = _splits(jcfg, m)
    if leaf in HEAD_ALIGNED or (leaf == "out_proj" and not split):
        a = _slice(whole, tuple(None if p == "model" else p for p in spec), coord, mesh)
        if leaf in HEAD_ALIGNED and split and m > 1:
            a = _head_slice(a, jcfg, leaf, coord["model"], m)
        return a
    return _slice(whole, spec, coord, mesh)


def _coord(r: dict) -> dict:
    return {"data": int(r["coord/data"]), "model": int(r["coord/model"])}


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_shards_are_their_slices(run, world, name):
    case = ALL[name]
    jcfg = _jcfg(case)
    specs, fallbacks = _specs(case, world)
    mesh = dict(zip(("data", "model"), world))
    whole = {k: run["ranks"][world][0][f"{name}/whole/{k}"] for k in specs}
    split = _splits(jcfg, mesh["model"])
    own = [["ssm_heads", jcfg.ssm_heads, ["model"], None]] * (0 if split else 4)
    n_split = 0
    for r in run["ranks"][world]:
        coord = _coord(r)
        for k, spec in specs.items():
            for prefix, src in (("init", run["weights"][name][k]), ("shard", whole[k])):
                want = _want(src, k, spec, coord, mesh, jcfg)
                got = r[f"{name}/{prefix}/{k}"]
                assert got.dtype == want.dtype and np.array_equal(got, want), (prefix, k)
            n_split += r[f"{name}/init/{k}"].shape != whole[k].shape
        got = json.loads(str(r[f"{name}/fallbacks"]))
        assert [f for f in got if not f[0].startswith("ssm_")] == fallbacks
        assert [f for f in got if f[0].startswith("ssm_")] == own
    assert n_split > 0
    saved = np.load(run["dirs"][world] / f"ckpt_{name}" / "step_00000002" / "arrays.npz")
    for k in specs:
        np.testing.assert_array_equal(saved[f"['params']{k}"], whole[k])


def _columns(jcfg, leaf: str, width: int, r: int, m: int) -> np.ndarray:
    """The whole leaf's last-axis indices of rank r of m's shard, in its
    order."""
    if m == 1 or not _splits(jcfg, m):
        return np.arange(width)
    return _head_slice(np.arange(width)[None], jcfg, leaf, r, m)[0]


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_copies_that_ranks_share_stay_equal(run, world, name):
    """After the steps, every value that several ranks hold is bitwise the
    same on each: the per-head vectors on all ranks; a shared group's B
    and C (and any column two ranks of one data coordinate hold) on every
    rank that holds it."""
    jcfg = _jcfg(ALL[name])
    ranks = run["ranks"][world]
    m = world[1]
    n_shared = 0
    for key in (k[len(f"{name}/shard/"):] for k in ranks[0] if k.startswith(f"{name}/shard/")):
        leaf = _mixer_leaf(key)
        if leaf in HEAD_VECTORS:
            for r in ranks:
                np.testing.assert_array_equal(r[f"{name}/shard/{key}"],
                                              ranks[0][f"{name}/shard/{key}"], err_msg=key)
        if leaf not in HEAD_ALIGNED:
            continue
        width = run["weights"][name][key].shape[-1]
        held: dict = {}
        for r in ranks:
            cols = _columns(jcfg, leaf, width, _coord(r)["model"], m)
            shard = r[f"{name}/shard/{key}"]
            for j, c in enumerate(cols):
                at = (_coord(r)["data"], int(c))
                if at in held:
                    np.testing.assert_array_equal(shard[..., j], held[at], err_msg=(key, c))
                    n_shared += 1
                else:
                    held[at] = shard[..., j]
    # mamba2 and zamba2 (G = 1) and G = 2 under 4 share B and C over "model"
    shares = m > jcfg.ssm_groups and _splits(jcfg, m)
    assert (n_shared > 0) == (shares or (m > 1 and not _splits(jcfg, m)))


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_global_norm_of_shards_equals_the_whole_trees(run, world, name):
    for r in run["ranks"][world]:
        np.testing.assert_allclose(r[f"{name}/norm/shards"], r[f"{name}/norm/whole"],
                                   rtol=1e-6)


# -- counts on a fake world of 4 ranks, on meta ------------------------------

COUNTS = r"""
import dataclasses, json, math
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import base
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.train import step

dryrun.open_fake_world(4)
mesh = make_mesh_compat((2, 2), ("data", "model"), device="meta")
shape = base.ShapeConfig("t", 64, 8, "train", accum=2)
mesh.group(("data", "model"))     # made once (it reads the mesh's rank tensor), before counting
out = {}
for arch in ("mamba2-2.7b", "zamba2-2.7b"):
    cfg = configs.smoke(arch)
    with shd.use_mesh(mesh, tensor.training_rules(mesh)):
        state = step.local_state(cfg)
    counter = dryrun.count_step(dryrun.build_step(cfg, shape, mesh))
    batch = dryrun._batch(cfg, shape, torch.device("meta"))
    out[arch] = {
        "state": sum(math.prod(i.shape) * i.dtype.itemsize for _, i in base.tree_items(state)),
        "whole": sum(math.prod(i.shape) * i.dtype.itemsize
                     for _, i in base.tree_items(step.abstract_state(cfg))),
        "inputs": sum(t.numel() * t.element_size() for t in batch.values()),
        "args": counter.arg_bytes, "coll": counter.summary()["breakdown"]}
    # the dry run's two analysis depths and a third, deeper one
    rows = []
    L1, L2 = dryrun.analysis_layers(cfg)
    for L in (L1, L2, 5 * L2 - 4 * L1):
        c = dataclasses.replace(cfg, n_layers=L)
        s = dryrun.count_step(dryrun.build_step(c, shape, mesh)).summary()
        rows.append([L, s["flops"], s["bytes"], s["arg_bytes"], s["coll"]])
    out[arch]["depths"] = rows
print(json.dumps(out))
"""


def test_counted_bytes_and_collectives_of_a_split_train_step_on_a_fake_world():
    """mamba2 and zamba2 smoke under (2, 2) on `meta`: the argument bytes
    are the state's shards, the inputs and the scalars the step makes; the
    collectives are `_tp_formula.ssm_train_collectives`'s; the FLOPs,
    bytes, argument and collective bytes lie on one line in the layer
    count through the dry run's two analysis depths."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", COUNTS], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro_torch import configs
    for arch, r in rec.items():
        cfg = configs.smoke(arch)
        assert r["state"] < r["whole"] / 2, arch
        # AdamW makes three fp32 scalars in the step (the clip norm, b1, b2)
        assert r["args"] == r["state"] + r["inputs"] + 12, arch
        want = ssm_train_collectives(cfg, data=2, model=2, batch=8, seq=64, accum=2)
        assert {k: r["coll"].get(k, 0) for k in want} == want, arch
        (l1, *a), (l2, *b), (l3, *c) = r["depths"]
        for x, y, z in zip(a, b, c):
            assert y > x and (y - x) * (l3 - l1) == (z - x) * (l2 - l1), arch
