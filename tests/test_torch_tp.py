"""Dense serving split over a model axis above 1 (`parallel/tensor.py`)
across gloo ranks on the CPU, held to the JAX package's unmeshed path.

Two worlds are started as processes (`tests/_tp_child.py`, which imports
torch and `repro_torch` only; its group comes from a `FileStore` in a
temporary directory; every spawn is killed at its timeout): 2 ranks on a
(1, 2) (data, model) mesh and 4 ranks on (1, 4). Each serves, at the
smoke size in fp32, qwen1.5-4b (heads and kv heads split: the cache by
kv heads), gemma-2b, llama3.2-3b and qwen2-vl-2b (kv 1: heads split, the
cache by positions) and musicgen-medium (heads split, LayerNorm, GELU,
sinusoidal positions), the vlm and audio ones with `make_batch`'s
extras; the 4-rank world also a qwen1.5-4b derived to take every
fallback (6 heads and 6 kv heads, vocab 510: heads, cache positions and
ffn are what split there), and one with 12 heads over 3 kv heads, whose
3 query heads a rank do not group evenly over the kv heads they use
(rank 1's use kv heads 0, 1, 1). Per world and config:

* prefill's last logits and those of 4 greedy decode steps within 1e-5
  of the largest |logit| of the reference's `api.prefill` and
  `decode_step` on the same weights, prompts and extras, and the greedy
  tokens equal (also those of `Engine.generate` under the mesh);
* each rank's parameter shard bitwise equal to the slice that the
  reference's `sharding.spec` gives its model coordinate under the
  serving rules, and the fallbacks recorded entry for entry as the
  reference records them;
* each rank's cache shard, after prefill and after each decode step,
  equal to the reference spec's slice of the port's unmeshed cache
  within 1e-5 of its largest magnitude.

Weights are drawn with numpy from a seed, at the reference's init
scales (every leaf random, biases and norm scales too); they cross into
the port with `models.convert.from_jax_params`.

And on a fake world of 4 ranks on `meta` (a subprocess: the group is
process-wide): the counted argument bytes of a split prefill and decode
step equal the shards' and the cache slice's sizes plus the inputs' (and
gemma's bf16 embedding scale), their collectives equal a formula
(`tests/_tp_formula.py`), and the split path's FLOPs, bytes, argument
and collective bytes lie on one line in the layer count (a 2048-token
flash prefill too), through the dry run's two analysis depths: what lets
`dryrun.analyze_cell` extend two counts.
"""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.models import base as jbase
from repro.parallel import sharding as jshd

from _gloo_world import spawn
from _tp_formula import split_collectives

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_tp_child.py")
TIMEOUT = 240
TOL = 1e-5
B, P, STEPS, MAX_LEN = 2, 8, 4, 16
ARCHS = ("qwen1.5-4b", "gemma-2b", "llama3.2-3b", "qwen2-vl-2b", "musicgen-medium")
FALLBACKS = {"name": "qwen1.5-4b-fallbacks", "arch": "qwen1.5-4b",
             "over": {"n_heads": 6, "n_kv_heads": 6, "vocab": 510}}
UNEVEN = {"name": "qwen1.5-4b-uneven-kv", "arch": "qwen1.5-4b",
          "over": {"n_heads": 12, "n_kv_heads": 3}}
CASES = {2: [{"name": a, "arch": a, "over": {}} for a in ARCHS],
         4: [{"name": a, "arch": a, "over": {}} for a in ARCHS] + [FALLBACKS, UNEVEN]}
WORLD_CASES = [(w, c["name"]) for w, cases in CASES.items() for c in cases]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _jcfg(case: dict):
    import dataclasses
    return dataclasses.replace(jconfigs.smoke(case["arch"]), compute_dtype="float32",
                               **case["over"])


def _weights(jcfg, seed: int):
    """Every leaf random: normal at the reference's init scale, zeros and
    ones (biases, norm scales) moved by N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(japi.abstract_params(jcfg),
                                                           is_leaf=jbase.is_info)
    out = []
    for _, info in leaves:
        if info.init == "normal":
            fan_in = info.shape[info.fan] if info.shape else 1
            a = rng.normal(0, info.scale / math.sqrt(max(fan_in, 1)), info.shape)
        else:
            a = rng.normal(0, 0.02, info.shape) + (1.0 if info.init == "ones" else 0.0)
        out.append(a.astype(np.float32))
    return [jax.tree_util.keystr(p) for p, _ in leaves], treedef, out


def _reference(jcfg, jp, prompts, extras) -> dict:
    """The reference's unmeshed prefill and STEPS greedy decode steps."""
    cache = jbase.tree_init(japi.abstract_cache(jcfg, B, MAX_LEN), jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(prompts), **{k: jnp.asarray(v) for k, v in extras.items()}}
    logits, cache = jax.jit(functools.partial(japi.prefill, jcfg))(jp, batch, cache)
    step = jax.jit(functools.partial(japi.decode_step, jcfg))
    pos = jnp.full((B,), P, jnp.int32)
    out = {}
    for i in range(STEPS + 1):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out[f"logits{i}"], out[f"tokens{i}"] = np.asarray(logits), np.asarray(tok)
        if i < STEPS:
            logits, cache = step(jp, tok[:, None], pos, cache)
            pos = pos + 1
    return out


def _slice(a: np.ndarray, spec, coord: int, m: int) -> np.ndarray:
    """Model coordinate `coord`'s slice of `a` under `spec` (data is 1)."""
    for dim, part in enumerate(spec):
        names = [part] if isinstance(part, str) else list(part or [])
        if "model" in names:
            n = a.shape[dim] // m
            a = np.take(a, range(coord * n, (coord + 1) * n), axis=dim)
    return a


def serve_world(world: int, d: Path, world_cases: list, seed: int = 100) -> dict:
    """Run the reference on every case of `world_cases` (weights from seeds
    `seed` + i), hand the inputs to a world of `world` ranks, and gather
    both sides."""
    cases = {}
    for i, case in enumerate(world_cases):
        jcfg = _jcfg(case)
        keys, treedef, leaves = _weights(jcfg, seed=seed + i)
        jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
        batch = jpipeline.make_batch(jcfg, jbase.ShapeConfig("tp", P, B, "prefill"), 0)
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "targets", "loss_mask")}
        prompts = batch["tokens"]
        np.savez(d / f"{case['name']}.npz", prompts=prompts,
                 **{f"w/{k}": a for k, a in zip(keys, leaves)},
                 **{f"x/{k}": v for k, v in extras.items()})
        rules = {"batch": ("data",), "fsdp": ()}
        with jshd.use_mesh(FakeMesh({"data": 1, "model": world}), rules):
            pspecs = jbase.tree_specs(japi.abstract_params(jcfg))
            fallbacks = jshd.fallbacks()
            cspecs = jbase.tree_specs(japi.abstract_cache(jcfg, B, MAX_LEN))
        flat = jax.tree_util.tree_flatten_with_path(
            pspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
        cases[case["name"]] = {
            "ref": _reference(jcfg, jp, prompts, extras),
            "weights": dict(zip(keys, leaves)),
            "specs": {jax.tree_util.keystr(k): s for k, s in flat},
            "cache_spec": cspecs["k"], "fallbacks": json.loads(json.dumps(fallbacks))}
    (d / "cases.json").write_text(json.dumps(
        [dict(c, max_len=MAX_LEN, steps=STEPS) for c in world_cases]))
    return {"cases": cases, "ranks": spawn(CHILD, world, d, TIMEOUT, prefix="tp_")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """World size -> its results, each world run once, when first asked."""
    made: dict = {}

    def get(world: int) -> dict:
        if world not in made:
            made[world] = serve_world(world, tmp_path_factory.mktemp(f"tp{world}"),
                                      CASES[world])
        return made[world]

    return get


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_split_logits_match_the_reference(worlds, world, name):
    w = worlds(world)
    ref = w["cases"][name]["ref"]
    for r in w["ranks"]:
        for i in range(STEPS + 1):
            want = ref[f"logits{i}"]
            bound = TOL * np.abs(want).max()
            for side in ("split", "plain"):
                got = r[f"{name}/{side}/logits{i}"]
                assert got.shape == want.shape, (side, i)
                assert np.abs(got - want).max() <= bound, (side, i)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_split_greedy_tokens_equal_the_reference(worlds, world, name):
    w = worlds(world)
    ref = w["cases"][name]["ref"]
    want = np.stack([ref[f"tokens{i}"] for i in range(STEPS + 1)], axis=1)
    for r in w["ranks"]:
        got = np.stack([r[f"{name}/split/tokens{i}"] for i in range(STEPS + 1)], axis=1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(r[f"{name}/generate"], want)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_parameter_shards_are_the_reference_specs_slices(worlds, world, name):
    w = worlds(world)
    case = w["cases"][name]
    n_split = 0
    for r in w["ranks"]:
        coord = int(r[f"{name}/coordinate"])
        for key, whole in case["weights"].items():
            want = _slice(whole, case["specs"][key], coord, world)
            got = r[f"{name}/shard/{key}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), key
            n_split += got.shape != whole.shape
        assert json.loads(str(r[f"{name}/fallbacks"])) == case["fallbacks"]
    assert n_split > 0


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_cache_shards_are_slices_of_the_unmeshed_cache(worlds, world, name):
    w = worlds(world)
    spec = w["cases"][name]["cache_spec"]
    for r in w["ranks"]:
        coord = int(r[f"{name}/coordinate"])
        for i in range(STEPS + 1):
            for kv in "kv":
                plain = r[f"{name}/plain/{kv}{i}"]
                want = _slice(plain, spec, coord, world)
                got = r[f"{name}/split/{kv}{i}"]
                assert got.shape == want.shape and got.shape != plain.shape, (kv, i)
                assert np.abs(got - want).max() <= TOL * np.abs(plain).max(), (kv, i)


def test_fallback_config_takes_every_fallback(worlds):
    """The derived config at model 4: heads, kv heads and vocab whole
    (recorded), so only the ffn and the cache's positions split."""
    case = worlds(4)["cases"][FALLBACKS["name"]]
    assert {(f[0], f[1]) for f in case["fallbacks"]} == {
        ("heads", 6), ("kv_heads", 6), ("vocab", 510)}
    assert case["cache_spec"] == jax.sharding.PartitionSpec(None, "data", None, "model")


# -- counts on a fake world of 4 ranks, on meta ------------------------------

COUNTS = r"""
import dataclasses, json, math
import torch
from repro_torch import configs
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import api, base
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor

dryrun.open_fake_world(4)
mesh = make_mesh_compat((1, 4), ("data", "model"), device="meta")
out = {}
for arch in ("qwen1.5-4b", "gemma-2b"):
    cfg = configs.smoke(arch)
    for kind in ("prefill", "decode"):
        shape = base.ShapeConfig(kind, 64, 4, kind)
        with shd.use_mesh(mesh, tensor.serving_rules()):
            ptree = tensor.local_tree(cfg, api.abstract_params(cfg))
            ctree = tensor.local_tree(cfg, api.abstract_cache(cfg, 4, 64))
        nbytes = lambda tree: sum(math.prod(i.shape) * i.dtype.itemsize
                                  for _, i in base.tree_items(tree))
        step = dryrun.build_step(cfg, shape, mesh, variant={"rules": tensor.serving_rules()})
        counter = dryrun.count_step(step)
        batch = dryrun._batch(cfg, shape, torch.device("meta"))
        out[f"{arch}/{kind}"] = {
            "params": nbytes(ptree), "cache": nbytes(ctree), "args": counter.arg_bytes,
            "inputs": sum(t.numel() * t.element_size() for t in batch.values()),
            "coll": counter.summary()["breakdown"]}
# the split path's counts at the dry run's analysis depths and beyond
for arch in ("qwen1.5-4b", "gemma-2b"):
    for kind, S in (("prefill", 64), ("decode", 64), ("prefill", 2048)):
        shape = base.ShapeConfig(kind, S, 4, kind)
        rows = []
        for L in (*dryrun.analysis_layers(configs.smoke(arch)), 9):
            cfg = dataclasses.replace(configs.smoke(arch), n_layers=L)
            s = dryrun.count_step(dryrun.build_step(
                cfg, shape, mesh, variant={"rules": tensor.serving_rules()})).summary()
            rows.append([L, s["flops"], s["bytes"], s["arg_bytes"], s["coll"]])
        out[f"{arch}/{kind}{S}/depths"] = rows
print(json.dumps(out))
"""


def test_counted_bytes_and_collectives_on_a_fake_world():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", COUNTS], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro_torch import configs
    for arch in ("qwen1.5-4b", "gemma-2b"):
        cfg = configs.smoke(arch)
        for kind in ("prefill", "decode"):
            r = rec[f"{arch}/{kind}"]
            # gemma's embedding scale is a bf16 scalar made in the step
            scale = 2 if cfg.scale_embedding else 0
            assert r["args"] == r["params"] + r["cache"] + r["inputs"] + scale, (arch, kind)
            want = split_collectives(cfg, kind, 4, 64, 4)
            assert {k: r["coll"].get(k, 0) for k in want} == want, (arch, kind)
        for kind in ("prefill64", "decode64", "prefill2048"):
            # FLOPs, bytes, argument and collective bytes on one line in the
            # layer count, through the dry run's two analysis depths
            (l1, *a), (l2, *b), (l3, *c) = rec[f"{arch}/{kind}/depths"]
            for x, y, z in zip(a, b, c):
                assert y > x and (y - x) * (l3 - l1) == (z - x) * (l2 - l1), (arch, kind)
