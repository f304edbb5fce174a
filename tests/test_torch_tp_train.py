"""Dense training under a model axis above 1, with FSDP over "data"
(`parallel/{tensor,fsdp}.py`, `train/step.py`), across gloo ranks on the
CPU, held to the JAX package's one-process train step and to the port's.

Three worlds are started as processes (`tests/_tp_train_child.py`, which
imports torch and `repro_torch` only; its group comes from a `FileStore`
in a temporary directory; every spawn is killed at its timeout): (data,
model) = (1, 2), (2, 2) and (1, 4), under the reference trainer's rules
(fsdp over "data"). Each trains, at the smoke size in fp32, qwen1.5-4b,
gemma-2b, llama3.2-3b, qwen2-vl-2b and musicgen-medium (2 steps of 4 x 16
tokens in 2 microbatches, `trainer.run` resumed from the case's initial
state, remat="full"), and qwen2-vl-2b through `make_train_step` on
batches whose loss mask gives rows, and so the two data ranks of (2, 2),
unequal token counts; the (1, 4) world also test_torch_tp.py's two
derived configs (heads, kv heads and vocab whole; 12 heads over 3 kv
heads, grouped unevenly a rank). Every leaf of the initial state is
drawn with numpy from a seed at the reference's init scales (biases and
norm scales moved off 0 and 1), m, v and the step zero. Per world and
case:

* losses within 1e-6 relative of the reference's two steps
  (`repro.train.step`, in `tests/_pinned_parent.py`'s pinned subprocess
  on one thread), and the whole parameters gathered from the ranks
  within 1e-6 of their largest magnitude wherever the reference's
  gradient stayed above EPS_REGIME (100 x AdamW's eps) in both steps,
  within 2 lr elsewhere: test_torch_mesh.py's criterion (below that an
  element's step follows the fp32 summation order of its gradient). At
  least SHARE of the elements are held at 1e-6: the rest are mostly the
  embedding rows of tokens absent from the 64-token batches, whose
  gradient is zero (0.74 to 0.998 of them held over the cases, CPU run);
* the same against the port's one-process steps, but for one leaf held
  by its gradient and not by its value, as test_torch_mesh.py holds it:
  the key bias `bk`, whose gradient cancels over positions, so that the
  order of its fp32 sums (another on 4 ranks, whose uneven query-head
  groups each sum a part of a kv head's gradient) moves its Adam step
  by more than 1e-6 of the largest parameter in places (1.2e-6 for the
  uneven-kv config, CPU run); every leaf's gradient on the first batch
  (remat="full", the backward and so each layer's recompute on another
  thread, as on a CUDA device thread), gathered from the ranks, within
  1e-6 of the largest |g| of one process's; and the grad norms within
  1e-6 relative;
* every rank's initial shards bitwise equal to the slices that the
  reference's `sharding.spec` gives its (data, model) coordinate under
  the training rules, its final shards bitwise the same slices of the
  whole result, the fallbacks recorded entry for entry as the
  reference's, and the checkpoint the trainer wrote at step 2 (rank 0,
  from every rank's shards) equal to the whole result;
* `global_norm` of the initial parameters' shards, each leaf's squares
  summed over the axes that cut it, within 1e-6 of the whole tree's.

Each world also holds `copy_to`, `reduce_from`, `gather_from`,
`fsdp.gather` and `vocab_nll` to one process (outputs and input
gradients within 1e-6). In this process: the MoE, ssm and hybrid
families take a model axis above 1 (their split training is
tests/test_torch_tp_moe.py's and tests/test_torch_tp_ssm_train.py's).
And on a fake world of 4 ranks on `meta` (a subprocess): the counted
argument bytes of a dense train step under (2, 2) equal its state
shards' and its inputs' (and the scalars the step makes), and its
collectives equal a formula (`tests/_tp_formula.train_collectives`).
"""
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _pinned_parent import ENV as PINNED_ENV
from _tp_formula import train_collectives
from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import base as jbase
from repro.parallel import sharding as jshd
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.models import base
from repro_torch.train import step

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_tp_train_child.py")
PINNED = Path(__file__).with_name("_pinned_parent.py")
TIMEOUT = 240
LR = 1e-3
EPS_REGIME = 1e-6   # |g| below 100 x AdamW's eps of 1e-8 (module doc)
SHARE = 0.7         # of the elements held at 1e-6 of the reference (module doc)
ARCHS = ("qwen1.5-4b", "gemma-2b", "llama3.2-3b", "qwen2-vl-2b", "musicgen-medium")
BASE = {"seq": 16, "batch": 4, "accum": 2, "lr": LR, "data_seed": 5}
MASK = {"name": "qwen2-vl-2b-mask", "arch": "qwen2-vl-2b", "over": {}, "own_batches": True}
FALLBACKS = {"name": "qwen1.5-4b-fallbacks", "arch": "qwen1.5-4b",
             "over": {"n_heads": 6, "n_kv_heads": 6, "vocab": 510}}
UNEVEN = {"name": "qwen1.5-4b-uneven-kv", "arch": "qwen1.5-4b",
          "over": {"n_heads": 12, "n_kv_heads": 3}}
PLAIN = [{"name": a, "arch": a, "over": {}} for a in ARCHS] + [MASK]
WORLDS = {(1, 2): PLAIN, (2, 2): PLAIN, (1, 4): PLAIN + [FALLBACKS, UNEVEN]}
ALL = {c["name"]: dict(BASE, **c) for cases in WORLDS.values() for c in cases}
WORLD_CASES = [(w, c["name"]) for w, cases in WORLDS.items() for c in cases]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _jcfg(case: dict):
    return dataclasses.replace(jconfigs.smoke(case["arch"]), compute_dtype="float32",
                               **case["over"])


def _weights(jcfg, seed: int) -> dict:
    """Every leaf random: normal at the reference's init scale, zeros and
    ones (biases, norm scales) moved by N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    leaves = jax.tree_util.tree_flatten_with_path(japi.abstract_params(jcfg),
                                                  is_leaf=jbase.is_info)[0]
    out = {}
    for path, info in leaves:
        if info.init == "normal":
            fan_in = info.shape[info.fan] if info.shape else 1
            a = rng.normal(0, info.scale / math.sqrt(max(fan_in, 1)), info.shape)
        else:
            a = rng.normal(0, 0.02, info.shape) + (1.0 if info.init == "ones" else 0.0)
        out[jax.tree_util.keystr(path)] = a.astype(np.float32)
    return out


def _mask_batches(jcfg, shape) -> dict:
    """Two batches whose loss masks give the rows (and so each data rank's
    half of a microbatch) unequal token counts."""
    from repro.data import pipeline as jpipeline
    rng = np.random.default_rng(9)
    out = {}
    for i in range(2):
        b = jpipeline.make_batch(jcfg, shape, i, seed=21)
        b["loss_mask"] = (rng.random(b["loss_mask"].shape) < [[0.9], [0.2], [0.6], [0.4]]
                          ).astype(np.float32)
        out.update({f"b{i}/{k}": v for k, v in b.items()})
    return out


def _save_case(d: Path, case: dict, seed: int) -> dict:
    """The case's weights (and batches) as <d>/<name>.npz and its whole
    initial train state as step 0 of <d>/ckpt_<name>; the weights."""
    jcfg = _jcfg(case)
    w = _weights(jcfg, seed)
    extra = {}
    if case.get("own_batches"):
        extra = _mask_batches(jcfg, jbase.ShapeConfig("s", case["seq"], case["batch"], "train",
                                                      accum=case["accum"]))
    np.savez(d / f"{case['name']}.npz", **{f"w/{k}": v for k, v in w.items()}, **extra)
    cfg = dataclasses.replace(configs.smoke(case["arch"]), compute_dtype="float32",
                              **case["over"])
    state = base.tree_init(step.abstract_state(cfg), torch.Generator(), "cpu")
    paths = [p for p, _ in base.tree_items(state["params"])]
    state["params"] = base.tree_unflatten(paths, [torch.from_numpy(w[base.keystr(p)])
                                                  for p in paths])
    ckpt.save(str(d / f"ckpt_{case['name']}"), 0, state)
    return w


def _spawn(shape: tuple, d: Path) -> list[dict]:
    data, model = shape
    world = data * model
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    logs = [open(d / f"tp_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(r), str(data), str(model),
                               str(d)], env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r}:\n" + (d / f"tp_{r}.log").read_text()[-3000:]
                          for r in range(world))
        raise AssertionError(f"world {shape}: exit codes {[p.returncode for p in procs]}\n"
                             f"{tails}")
    return [dict(np.load(d / f"tp_{r}.npz")) for r in range(world)]


def _specs(case: dict, shape: tuple) -> tuple[dict, list]:
    """The reference's parameter specs and fallbacks under a (data, model)
    mesh of `shape` and its trainer's rules."""
    with jshd.use_mesh(FakeMesh(dict(zip(("data", "model"), shape))), {"batch": ("data",)}):
        specs = jbase.tree_specs(japi.abstract_params(_jcfg(case)))
        fallbacks = jshd.fallbacks()
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return ({jax.tree_util.keystr(k): s for k, s in flat},
            json.loads(json.dumps(fallbacks)))


def train_worlds(d: Path, cases: dict, worlds: dict, seed: int) -> dict:
    """The reference's steps of every case of `cases` ({name: case}; one
    pinned subprocess, the cases' weights drawn from seeds `seed` + i),
    and the ranks of each world of `worlds` ({(data, model): cases}), one
    world after the other beside it; {"ranks": {world: results},
    "ref": {name: {loss, params, gmin, grad0}}, "weights", "dirs"}."""
    weights = {}
    for i, (name, case) in enumerate(cases.items()):
        weights[name] = _save_case(d, case, seed=seed + i)
    (d / "cases.json").write_text(json.dumps(list(cases.values())))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **PINNED_ENV}
    log = open(d / "pinned_tp.log", "w")
    pinned = subprocess.Popen([sys.executable, str(PINNED), "tp", str(d)], env=env,
                              stdout=log, stderr=subprocess.STDOUT)
    dirs = {}
    try:
        for shape, world_cases in worlds.items():
            wd = d / "x".join(map(str, shape))
            wd.mkdir()
            for case in world_cases:
                (wd / f"{case['name']}.npz").symlink_to(d / f"{case['name']}.npz")
                shutil.copytree(d / f"ckpt_{case['name']}", wd / f"ckpt_{case['name']}")
            (wd / "cases.json").write_text(json.dumps([cases[c["name"]] for c in world_cases]))
            dirs[shape] = wd
        # the worlds one after the other (each holds 2 or 4 processes), the
        # reference beside them
        ranks = {shape: _spawn(shape, wd) for shape, wd in dirs.items()}
    finally:
        try:
            pinned.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            pinned.kill()
            pinned.wait()
        log.close()
    if pinned.returncode:
        raise AssertionError("pinned tp: exit code " + str(pinned.returncode) + "\n"
                             + (d / "pinned_tp.log").read_text()[-3000:])
    z = np.load(d / "tp_ref.npz")
    ref = {}
    for name in cases:
        ref[name] = {"loss": z[f"{name}/loss"], "params": {}, "gmin": {}, "grad0": {}}
        for key in z.files:
            for part in ("params", "gmin", "grad0"):
                head = f"{name}/{part}/"
                if key.startswith(head):
                    ref[name][part][key[len(head):]] = z[key]
    return {"ranks": ranks, "ref": ref, "weights": weights, "dirs": dirs}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's steps of every case and each world's ranks; world
    -> results."""
    return train_worlds(tmp_path_factory.mktemp("tp_train"), ALL, WORLDS, seed=200)


NOISE = ("['layers']['attn']['bk']",)     # gradients at AdamW's eps (module doc)


def _close(got: dict, prefix: str, want: dict, gmin: dict, noise=()):
    """Parameters but `noise` within 1e-6 of their largest magnitude where
    `gmin` stayed above EPS_REGIME, within the two steps' 2 lr elsewhere;
    the share of elements held at 1e-6."""
    scale = max(np.abs(v).max() for v in want.values())
    n_sure = n = 0
    for k, v in want.items():
        if k in noise:
            continue
        d = np.abs(got[f"{prefix}/{k}"] - v)
        sure = gmin[k] > EPS_REGIME
        assert d[sure].max(initial=0) <= 1e-6 * scale, (prefix, k, d[sure].max() / scale)
        assert d.max() <= 2 * LR, (prefix, k)
        n_sure, n = n_sure + int(sure.sum()), n + sure.size
    return n_sure / n


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
    _close(lead, f"{name}/whole", plain, ref["gmin"], NOISE)
    # every leaf's gradient, NOISE's too, on the first batch from the
    # initial state
    grads = {k: lead[f"{name}/grad/plain/{k}"] for k in ref["params"]}
    scale = max(np.abs(v).max() for v in grads.values())
    for k, v in grads.items():
        assert np.abs(lead[f"{name}/grad/whole/{k}"] - v).max() <= 1e-6 * scale, k


def _slice(a: np.ndarray, spec, coord: dict, shape: dict) -> np.ndarray:
    """The slice of `a` that `spec` gives the mesh coordinate `coord`."""
    for dim, part in enumerate(spec):
        names = [part] if isinstance(part, str) else list(part or [])
        if not names:
            continue
        idx, n = 0, math.prod(shape[a_] for a_ in names)
        for a_ in names:
            idx = idx * shape[a_] + coord[a_]
        size = a.shape[dim] // n
        a = np.take(a, range(idx * size, (idx + 1) * size), axis=dim)
    return a


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_shards_are_the_reference_specs_slices(run, world, name):
    case = ALL[name]
    specs, fallbacks = _specs(case, world)
    mesh = dict(zip(("data", "model"), world))
    whole = {k: run["ranks"][world][0][f"{name}/whole/{k}"] for k in specs}
    n_split = 0
    for r in run["ranks"][world]:
        coord = {"data": int(r["coord/data"]), "model": int(r["coord/model"])}
        for k, spec in specs.items():
            for prefix, src in (("init", run["weights"][name][k]), ("shard", whole[k])):
                want = _slice(src, spec, coord, mesh)
                got = r[f"{name}/{prefix}/{k}"]
                assert got.dtype == want.dtype and np.array_equal(got, want), (prefix, k)
            n_split += r[f"{name}/init/{k}"].shape != whole[k].shape
        assert json.loads(str(r[f"{name}/fallbacks"])) == fallbacks
    assert n_split > 0
    if not case.get("own_batches"):
        saved = np.load(run["dirs"][world] / f"ckpt_{name}" / "step_00000002" / "arrays.npz")
        for k in specs:
            np.testing.assert_array_equal(saved[f"['params']{k}"], whole[k])


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_global_norm_of_shards_equals_the_whole_trees(run, world, name):
    for r in run["ranks"][world]:
        np.testing.assert_allclose(r[f"{name}/norm/shards"], r[f"{name}/norm/whole"],
                                   rtol=1e-6)


@pytest.mark.parametrize("world", list(WORLDS))
def test_autograd_collectives_equal_one_process(run, world):
    for r in run["ranks"][world]:
        units = {k: float(v) for k, v in r.items() if k.startswith("unit/")}
        assert len(units) == 9 and max(units.values()) <= 1e-6, units


class _GroupMesh(FakeMesh):
    """A (data, model) mesh shape whose `group` names its axes."""

    def group(self, axes):
        return ("group", tuple(axes))

    def size(self, axes):
        return math.prod(self.shape[a] for a in axes)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b", "zamba2-2.7b"])
def test_moe_ssm_and_hybrid_take_a_model_axis(arch, monkeypatch):
    """The MoE, ssm and hybrid families train under a model axis above 1
    (the MoE family's split training is tests/test_torch_tp_moe.py's):
    `_data_parallel` gives the data group and this rank's rows (rank 1 of
    2 data ranks)."""
    cfg = configs.smoke(arch)
    mesh = _GroupMesh({"data": 2, "model": 2})
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3)}
    monkeypatch.setattr(step.dist, "get_rank", lambda group=None: 1)
    group, rows = step._data_parallel(cfg, mesh, batch, 2)
    assert group == ("group", ("data",))
    # microbatch i of the global batch is rows [4 i, 4 i + 4); rank 1 takes
    # the second half of each
    assert torch.equal(rows["tokens"], batch["tokens"][[2, 3, 6, 7]])


# -- counts on a fake world of 4 ranks, on meta ------------------------------

COUNTS = r"""
import json, math
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
for arch in ("qwen1.5-4b", "gemma-2b", "musicgen-medium"):
    cfg = configs.smoke(arch)
    with shd.use_mesh(mesh, tensor.training_rules(mesh)):
        state = step.local_state(cfg)
    counter = dryrun.count_step(dryrun.build_step(cfg, shape, mesh))
    batch = dryrun._batch(cfg, shape, torch.device("meta"))
    out[arch] = {
        "state": sum(math.prod(i.shape) * i.dtype.itemsize for _, i in base.tree_items(state)),
        "inputs": sum(t.numel() * t.element_size() for t in batch.values()),
        "args": counter.arg_bytes, "coll": counter.summary()["breakdown"]}
print(json.dumps(out))
"""


def test_counted_bytes_and_collectives_of_a_train_step_on_a_fake_world():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", COUNTS], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch, r in rec.items():
        cfg = configs.smoke(arch)
        # AdamW makes three fp32 scalars in the step (the clip norm, b1, b2)
        # and gemma's embedding one bf16 scale a microbatch
        made = 12 + (2 * 2 if cfg.scale_embedding else 0)
        assert r["args"] == r["state"] + r["inputs"] + made, arch
        want = train_collectives(cfg, data=2, model=2, batch=8, seq=64, accum=2)
        assert {k: r["coll"].get(k, 0) for k in want} == want, arch
