"""The MoE family served and trained under a model axis above 1: expert
parallelism (`layers/moe.py`, `parallel/{tensor,fsdp}.py`,
`train/step.py`), across gloo ranks on the CPU, held to the JAX
package's unmeshed paths and to the port's one process.

The worlds are started as processes (`tests/_tp_child.py` and
`tests/_tp_train_child.py`, which import torch and `repro_torch` only;
each group comes from a `FileStore` in a temporary directory; every spawn
is killed at its timeout). The cases, at the smoke size in fp32:
granite-moe-1b-a400m (8 experts, top 2, 2 kv heads), qwen3-moe-30b-a3b
(`moe_norm_topk`, 1 kv head) and granite-moe derived to 6 experts, which
split 3 a rank under 2 and stay whole on every rank under 4 (a recorded
fallback). Weights are drawn with numpy from a seed at the reference's
init scales (every leaf random, norm scales moved off 1).

* Serving on (1, 2) and (1, 4) (test_torch_tp.py's criteria): prefill's
  last logits and those of 4 greedy decode steps within 1e-5 of the
  largest |logit| of the reference's `api.prefill` and `decode_step`,
  the greedy tokens equal (those of `Engine.generate` under the mesh
  too); each rank's parameter shards bitwise the slices of the
  reference's `sharding.spec` under the serving rules (the experts E/m a
  rank, the router whole) and the fallbacks entry for entry the
  reference's; each rank's cache shard the spec's slice of the unmeshed
  cache. Every rank routes all of its tokens, so the capacity (5 at
  prefill, 1 at decode) drops the pairs the unmeshed layer drops.
* Training on (1, 2), (2, 2) and (1, 4) (test_torch_tp_train.py's
  criteria): 2 steps of 4 x 16 tokens in 2 microbatches, `trainer.run`
  resumed from the case's initial state with remat="full"; losses within
  1e-6 relative of the reference's one-process steps (in
  `tests/_pinned_parent.py`'s pinned subprocess) and the whole
  parameters gathered from the ranks by the criterion of
  test_torch_tp_train.py; the same against the port's one process, whose
  losses and grad norms the ranks' equal within 1e-6 relative, and every
  leaf's gradient on the first batch (the router's and the experts'
  among them), gathered from the ranks, within 1e-6 of the largest |g|
  of one process's; the shards bitwise their spec's slices (the experts
  over "model" and their d over "data", the router's d over "data"), the
  fallbacks the reference's, the step-2 checkpoint the whole result; the
  router, which the split holds whole over "model", bitwise equal on the
  model ranks of each data coordinate after the steps; `global_norm` of
  the shards within 1e-6 of the whole tree's.

And on a fake world of 4 ranks on `meta` (a subprocess: the group is
process-wide): the collectives of a split MoE prefill and decode step
under (1, 4) equal `_tp_formula.split_collectives`, and those of a train
step under (2, 2), (1, 4) and (4, 1) `_tp_formula.moe_train_collectives`;
the counted argument bytes of the serving steps are the shards', the
cache slice's and the inputs', those of the train steps the state
shards', the inputs' and the scalars the step makes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _tp_formula import moe_train_collectives, split_collectives
from test_torch_tp import STEPS
from test_torch_tp import _slice as _model_slice
from test_torch_tp import serve_world
from test_torch_tp_train import LR, SHARE, _close, _slice, _specs, train_worlds

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = 1e-5
GRANITE = {"name": "granite-moe-1b-a400m", "arch": "granite-moe-1b-a400m", "over": {}}
QWEN3 = {"name": "qwen3-moe-30b-a3b", "arch": "qwen3-moe-30b-a3b", "over": {}}
E6 = {"name": "granite-moe-e6", "arch": "granite-moe-1b-a400m", "over": {"n_experts": 6}}
SERVE = {2: [GRANITE, QWEN3, E6], 4: [GRANITE, QWEN3, E6]}
SERVE_CASES = [(w, c["name"]) for w, cases in SERVE.items() for c in cases]
BASE = {"seq": 16, "batch": 4, "accum": 2, "lr": LR, "data_seed": 5}
TRAIN = {(1, 2): [GRANITE, QWEN3, E6], (2, 2): [GRANITE, QWEN3, E6],
         (1, 4): [GRANITE, QWEN3, E6]}
ALL = {c["name"]: dict(BASE, **c) for cases in TRAIN.values() for c in cases}
TRAIN_CASES = [(w, c["name"]) for w, cases in TRAIN.items() for c in cases]
ROUTER = "['layers']['moe']['router']"
EXPERTS = tuple(f"['layers']['moe']['{k}']" for k in ("wi", "wg", "wo"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """World size -> its results, each world run once, when first asked."""
    made: dict = {}

    def get(world: int) -> dict:
        if world not in made:
            made[world] = serve_world(world, tmp_path_factory.mktemp(f"tpmoe{world}"),
                                      SERVE[world], seed=600)
        return made[world]

    return get


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference's steps of every case and each world's ranks."""
    return train_worlds(tmp_path_factory.mktemp("tp_moe_train"), ALL, TRAIN, seed=700)


# -- serving --------------------------------------------------------------------

@pytest.mark.parametrize("world,name", SERVE_CASES)
def test_split_serving_matches_the_reference(served, world, name):
    """Every step's logits within 1e-5 of the largest |logit| (split and
    unmeshed), and the greedy tokens equal (split and `Engine.generate`)."""
    w = served(world)
    ref = w["cases"][name]["ref"]
    want = np.stack([ref[f"tokens{i}"] for i in range(STEPS + 1)], axis=1)
    for r in w["ranks"]:
        for i in range(STEPS + 1):
            bound = TOL * np.abs(ref[f"logits{i}"]).max()
            for side in ("split", "plain"):
                got = r[f"{name}/{side}/logits{i}"]
                assert np.abs(got - ref[f"logits{i}"]).max() <= bound, (side, i)
        got = np.stack([r[f"{name}/split/tokens{i}"] for i in range(STEPS + 1)], axis=1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(r[f"{name}/generate"], want)


@pytest.mark.parametrize("world,name", SERVE_CASES)
def test_serving_shards_and_caches_are_the_reference_specs_slices(served, world, name):
    w = served(world)
    case = w["cases"][name]
    E = case["weights"][EXPERTS[0]].shape[1]
    for r in w["ranks"]:
        coord = int(r[f"{name}/coordinate"])
        for key, whole in case["weights"].items():
            want = _model_slice(whole, case["specs"][key], coord, world)
            got = r[f"{name}/shard/{key}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), key
        # the experts E/m a rank where m divides E, else whole; the router whole
        for key in EXPERTS:
            assert r[f"{name}/shard/{key}"].shape[1] == (E // world if E % world == 0 else E)
        assert r[f"{name}/shard/{ROUTER}"].shape == case["weights"][ROUTER].shape
        assert json.loads(str(r[f"{name}/fallbacks"])) == case["fallbacks"]
        for i in range(STEPS + 1):
            for kv in "kv":
                plain = r[f"{name}/plain/{kv}{i}"]
                want = _model_slice(plain, case["cache_spec"], coord, world)
                got = r[f"{name}/split/{kv}{i}"]
                assert got.shape == want.shape and got.shape != plain.shape, (kv, i)
                assert np.abs(got - want).max() <= TOL * np.abs(plain).max(), (kv, i)


def test_experts_that_do_not_divide_stay_whole_and_are_recorded(served):
    """6 experts under 4: wi, wg and wo whole on every rank, each recorded
    as the reference records it; under 2 they split, nothing recorded."""
    four = served(4)["cases"][E6["name"]]["fallbacks"]
    assert [f for f in four if f[0] == "experts"] == [["experts", 6, ["model"], None]] * 3
    two = served(2)["cases"][E6["name"]]["fallbacks"]
    assert not [f for f in two if f[0] == "experts"]


# -- training -------------------------------------------------------------------

@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_split_training_matches_the_reference(trained, world, name):
    lead, ref = trained["ranks"][world][0], trained["ref"][name]
    for r in trained["ranks"][world]:
        np.testing.assert_allclose(r[f"{name}/loss"], ref["loss"], rtol=1e-6, atol=0)
    assert _close(lead, f"{name}/whole", ref["params"], ref["gmin"]) >= SHARE


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_split_training_matches_one_process(trained, world, name):
    """Losses and grad norms within 1e-6 relative, the parameters by the
    reference's criterion, and every leaf's first-batch gradient (the
    router's and the experts' among them) within 1e-6 of the largest |g|."""
    lead, ref = trained["ranks"][world][0], trained["ref"][name]
    plain = {k: lead[f"{name}/plain/{k}"] for k in ref["params"]}
    for r in trained["ranks"][world]:
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(r[f"{name}/{key}"], lead[f"{name}/plain/{key}"],
                                       rtol=1e-6, atol=0)
    _close(lead, f"{name}/whole", plain, ref["gmin"])
    grads = {k: lead[f"{name}/grad/plain/{k}"] for k in ref["params"]}
    scale = max(np.abs(v).max() for v in grads.values())
    for k, v in grads.items():
        assert np.abs(lead[f"{name}/grad/whole/{k}"] - v).max() <= 1e-6 * scale, k
    assert np.abs(grads[ROUTER]).max() > 0 and all(np.abs(grads[k]).max() > 0 for k in EXPERTS)


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_training_shards_are_the_reference_specs_slices(trained, world, name):
    specs, fallbacks = _specs(ALL[name], world)
    mesh = dict(zip(("data", "model"), world))
    ranks = trained["ranks"][world]
    whole = {k: ranks[0][f"{name}/whole/{k}"] for k in specs}
    for r in ranks:
        coord = {"data": int(r["coord/data"]), "model": int(r["coord/model"])}
        for k, spec in specs.items():
            for prefix, src in (("init", trained["weights"][name][k]), ("shard", whole[k])):
                want = _slice(src, spec, coord, mesh)
                got = r[f"{name}/{prefix}/{k}"]
                assert got.dtype == want.dtype and np.array_equal(got, want), (prefix, k)
        assert json.loads(str(r[f"{name}/fallbacks"])) == fallbacks
    saved = np.load(trained["dirs"][world] / f"ckpt_{name}" / "step_00000002" / "arrays.npz")
    for k in specs:
        np.testing.assert_array_equal(saved[f"['params']{k}"], whole[k])


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_router_copies_stay_equal_over_the_model_ranks(trained, world, name):
    """The router is whole over "model": after the steps its copies on the
    model ranks of each data coordinate are bitwise equal."""
    by_data: dict = {}
    for r in trained["ranks"][world]:
        by_data.setdefault(int(r["coord/data"]), []).append(r[f"{name}/shard/{ROUTER}"])
    for copies in by_data.values():
        assert len(copies) == world[1]
        for c in copies[1:]:
            np.testing.assert_array_equal(c, copies[0])


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_global_norm_of_shards_equals_the_whole_trees(trained, world, name):
    for r in trained["ranks"][world]:
        np.testing.assert_allclose(r[f"{name}/norm/shards"], r[f"{name}/norm/whole"],
                                   rtol=1e-6)


# -- counts on a fake world of 4 ranks, on meta ------------------------------

COUNTS = r"""
import dataclasses, json, math
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import api, base
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.train import step

dryrun.open_fake_world(4)
nbytes = lambda tree: sum(math.prod(i.shape) * i.dtype.itemsize
                          for _, i in base.tree_items(tree))
out = {}
for name, arch, over in (("granite", "granite-moe-1b-a400m", {}),
                         ("qwen3", "qwen3-moe-30b-a3b", {}),
                         ("e6", "granite-moe-1b-a400m", {"n_experts": 6})):
    cfg = dataclasses.replace(configs.smoke(arch), **over)
    mesh = make_mesh_compat((1, 4), ("data", "model"), device="meta")
    for kind in ("prefill", "decode"):
        shape = base.ShapeConfig(kind, 64, 4, kind)
        with shd.use_mesh(mesh, tensor.serving_rules()):
            ptree = tensor.local_tree(cfg, api.abstract_params(cfg))
            ctree = tensor.local_tree(cfg, api.abstract_cache(cfg, 4, 64))
        counter = dryrun.count_step(dryrun.build_step(
            cfg, shape, mesh, variant={"rules": tensor.serving_rules()}))
        batch = dryrun._batch(cfg, shape, torch.device("meta"))
        out[f"{name}/{kind}"] = {
            "params": nbytes(ptree), "cache": nbytes(ctree), "args": counter.arg_bytes,
            "inputs": sum(t.numel() * t.element_size() for t in batch.values()),
            "coll": counter.summary()["breakdown"]}
    for dm in ((2, 2), (1, 4), (4, 1)):
        mesh = make_mesh_compat(dm, ("data", "model"), device="meta")
        mesh.group(("data", "model"))   # made once (it reads the mesh's rank tensor)
        shape = base.ShapeConfig("t", 64, 8, "train", accum=2)
        with shd.use_mesh(mesh, tensor.training_rules(mesh)):
            state = step.local_state(cfg)
        counter = dryrun.count_step(dryrun.build_step(cfg, shape, mesh))
        batch = dryrun._batch(cfg, shape, torch.device("meta"))
        out[f"{name}/train/{dm[0]}x{dm[1]}"] = {
            "state": nbytes(state), "args": counter.arg_bytes,
            "inputs": sum(t.numel() * t.element_size() for t in batch.values()),
            "coll": counter.summary()["breakdown"]}
print(json.dumps(out))
"""


def test_counted_bytes_and_collectives_on_a_fake_world():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", COUNTS], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    import dataclasses

    from repro_torch import configs
    for name, case in (("granite", GRANITE), ("qwen3", QWEN3), ("e6", E6)):
        cfg = dataclasses.replace(configs.smoke(case["arch"]), **case["over"])
        for kind in ("prefill", "decode"):
            r = rec[f"{name}/{kind}"]
            assert r["args"] == r["params"] + r["cache"] + r["inputs"], (name, kind)
            want = split_collectives(cfg, kind, 4, 64, 4)
            assert {k: r["coll"].get(k, 0) for k in want} == want, (name, kind)
        for data, model in ((2, 2), (1, 4), (4, 1)):
            r = rec[f"{name}/train/{data}x{model}"]
            # AdamW makes three fp32 scalars in the step (the clip norm, b1, b2)
            assert r["args"] == r["state"] + r["inputs"] + 12, (name, data, model)
            want = moe_train_collectives(cfg, data=data, model=model, batch=8, seq=64, accum=2)
            assert {k: r["coll"].get(k, 0) for k in want} == want, (name, data, model)


class _Coordinate:
    """A (data, model) mesh shape and rank 0's coordinate on it."""

    def __init__(self, shape: dict):
        self.shape = shape

    def coordinate(self, axis: str) -> int:
        return 0

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in axes]))


def test_a_ranks_moe_leaves_on_the_production_mesh():
    """qwen3-moe-30b-a3b on 16 x 16: 8 of its 128 experts a rank, the
    router whole over "model"; in a train state every d over "data" too
    (2048 / 16), the router's included."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    cfg = configs.get_config(QWEN3["arch"])
    mesh = _Coordinate({"data": 16, "model": 16})
    with shd.use_mesh(mesh, tensor.serving_rules()):
        serve = tensor.local_tree(cfg, api.abstract_params(cfg))["layers"]["moe"]
    with shd.use_mesh(mesh, {"batch": ("data",)}):
        train = tensor.local_tree(cfg, api.abstract_params(cfg), tensor.TRAIN_AXES)
    train = train["layers"]["moe"]
    assert serve["wi"].shape == serve["wg"].shape == (48, 8, 2048, 768)
    assert serve["wo"].shape == (48, 8, 768, 2048) and serve["router"].shape == (48, 2048, 128)
    assert train["wi"].shape == train["wg"].shape == (48, 8, 128, 768)
    assert train["wo"].shape == (48, 8, 768, 128) and train["router"].shape == (48, 128, 128)
