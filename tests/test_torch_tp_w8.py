"""W8 checkpoints served split over a model axis above 1
(`parallel/tensor.py`, `quantized/apply.py`) across gloo ranks on the
CPU, held to the JAX package's unmeshed W8 path.

Two worlds are started as processes (`tests/_tp_w8_child.py`, which
imports torch and `repro_torch` only; its group comes from a `FileStore`
in a temporary directory; every spawn is killed at its timeout): 2 ranks
on a (1, 2) (data, model) mesh and 4 ranks on (1, 4). Each serves, at
the smoke size in fp32, the W8 tree of the reference's
`quantize_params_for_serving(..., min_size=0)` (every matmul weight
int8, with its scales) of qwen1.5-4b (heads and kv heads split),
gemma-2b (one kv head: the cache by positions; the tied W8 vocab split),
mamba2-2.7b (the segmented `in_proj`'s `q` and `s` by heads) and
zamba2-2.7b (its shared block's `wo` scales cut by heads), the whole tree
handed to `Engine`, which cuts it. Per world and config:

* prefill's last logits and those of 4 greedy decode steps within 1e-5
  of the largest |logit| of the reference's unmeshed W8 `api.prefill` and
  `decode_step` on the same tree, and the greedy tokens equal (also
  those of `Engine.generate` under the mesh); zamba2 against the port's
  unmeshed W8, as the reference raises on its shared block's W8
  attention at `min_size=0` (ROADMAP.md, C);
* each rank's `q` bitwise equal to its dense leaf's slice (the
  reference's spec at its model coordinate, or the head-aligned runs of
  a Mamba2 `in_proj`), and its `s` to the same cut along the scale's
  dims (first and last of a weight of three or more dims, else last),
  whole where those are not cut.

In this process: `abstract_quantized_params` keeps a Mamba2 `in_proj`'s
segments on `q` and `s` (and drops them from `out_proj`'s `s`); on a
fake world of 4 ranks on `meta` (a subprocess) `local_tree` of the W8
tree gives the shapes of the 4-rank world's shards, and the dry run's W8
serving variant (`{"quant": True, "rules": {"fsdp": ()}}`) counts a split
prefill and decode step whose argument bytes are the W8 shards', the
cache slice's and the inputs'; and a W8 MoE raises under a split as it
does unmeshed.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.models import base as jbase
from repro.parallel import sharding as jshd
from repro.quantized import apply as japply

from _gloo_world import spawn
from test_torch_tp import FakeMesh, _slice, _weights
from test_torch_tp_ssm import _head_slice, _jcfg, _splits

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_tp_w8_child.py")
TOL = 1e-5
B, P, STEPS, MAX_LEN = 2, 8, 4, 16
ARCHS = ("qwen1.5-4b", "gemma-2b", "mamba2-2.7b", "zamba2-2.7b")
UNSERVED = ("zamba2-2.7b",)      # the reference's W8 shared block raises at min_size=0
WORLDS = (2, 4)
WORLD_CASES = [(w, a) for w in WORLDS for a in ARCHS]
MIXER = "['layers']['mixer']"
MIXER_IN_PROJ = MIXER + "['in_proj']"     # cut by heads, as the conv's leaves


def _reference(jcfg, jq, prompts) -> dict:
    """The reference's unmeshed W8 prefill and STEPS greedy decode steps."""
    cache = jbase.tree_init(japi.abstract_cache(jcfg, B, MAX_LEN), jax.random.PRNGKey(0))
    logits, cache = jax.jit(functools.partial(japi.prefill, jcfg))(
        jq, {"tokens": jnp.asarray(prompts)}, cache)
    step = jax.jit(functools.partial(japi.decode_step, jcfg))
    pos = jnp.full((B,), P, jnp.int32)
    out = {}
    for i in range(STEPS + 1):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out[f"logits{i}"], out[f"tokens{i}"] = np.asarray(logits), np.asarray(tok)
        if i < STEPS:
            logits, cache = step(jq, tok[:, None], pos, cache)
            pos = pos + 1
    return out


def serve_world(world: int, d: Path) -> dict:
    cases = {}
    for i, arch in enumerate(ARCHS):
        case = {"name": arch, "arch": arch, "over": {}}
        jcfg = _jcfg(case)
        keys, treedef, leaves = _weights(jcfg, seed=300 + i)
        jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
        jq = japply.quantize_params_for_serving(jcfg, jp, min_size=0)
        w8 = {jax.tree_util.keystr(p): np.asarray(a)
              for p, a in jax.tree_util.tree_flatten_with_path(jq)[0]}
        prompts = jpipeline.make_batch(jcfg, jbase.ShapeConfig("w8", P, B, "prefill"),
                                       0)["tokens"]
        np.savez(d / f"{arch}.npz", prompts=prompts, **{f"w/{k}": a for k, a in w8.items()})
        with jshd.use_mesh(FakeMesh({"data": 1, "model": world}),
                           {"batch": ("data",), "fsdp": ()}):
            pspecs = jbase.tree_specs(japi.abstract_params(jcfg))
        flat = jax.tree_util.tree_flatten_with_path(
            pspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
        cases[arch] = {"jcfg": jcfg, "w8": w8,
                       "ref": None if arch in UNSERVED else _reference(jcfg, jq, prompts),
                       "specs": {jax.tree_util.keystr(k): s for k, s in flat}}
    (d / "cases.json").write_text(json.dumps(
        [{"name": a, "arch": a, "over": {}, "max_len": MAX_LEN, "steps": STEPS}
         for a in ARCHS]))
    return {"cases": cases, "ranks": spawn(CHILD, world, d)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    made: dict = {}

    def get(world: int) -> dict:
        if world not in made:
            made[world] = serve_world(world, tmp_path_factory.mktemp(f"w8_{world}"))
        return made[world]

    return get


def _want(w: dict, name: str) -> dict:
    """The reference's run, or for an unserved config rank 0's unmeshed
    port run."""
    ref = w["cases"][name]["ref"]
    return ref if ref is not None else {k[len(name) + 7:]: v for k, v in w["ranks"][0].items()
                                        if k.startswith(f"{name}/plain/")}


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_split_w8_logits_match_the_unmeshed_w8(worlds, world, name):
    w = worlds(world)
    want = _want(w, name)
    for r in w["ranks"]:
        for i in range(STEPS + 1):
            bound = TOL * np.abs(want[f"logits{i}"]).max()
            for side in ("split", "plain"):
                got = r[f"{name}/{side}/logits{i}"]
                assert got.shape == want[f"logits{i}"].shape, (side, i)
                assert np.abs(got - want[f"logits{i}"]).max() <= bound, (side, i)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_split_w8_greedy_tokens_equal_the_unmeshed_w8(worlds, world, name):
    w = worlds(world)
    want = _want(w, name)
    tokens = np.stack([want[f"tokens{i}"] for i in range(STEPS + 1)], axis=1)
    for r in w["ranks"]:
        got = np.stack([r[f"{name}/split/tokens{i}"] for i in range(STEPS + 1)], axis=1)
        np.testing.assert_array_equal(got, tokens)
        np.testing.assert_array_equal(r[f"{name}/generate"], tokens)


def _scale_spec(spec, ndim: int) -> tuple:
    """The spec of a W8 leaf's scales from its dense leaf's: the entries
    of its first and last dims (three or more dims), else of its last."""
    full = tuple(spec) + (None,) * (ndim - len(spec))
    return (full[0], full[-1]) if ndim >= 3 else (full[-1],)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_w8_shards_are_slices_of_the_whole_quantization(worlds, world, name):
    """Every rank's `q` and `s` bitwise equal to their cut of the
    unmeshed W8 leaves; the scales whole where their dims are not cut."""
    w = worlds(world)
    case = w["cases"][name]
    jcfg, n_cut, n_whole = case["jcfg"], 0, 0
    for r in w["ranks"]:
        coord = int(r[f"{name}/coordinate"])
        for key, whole in case["w8"].items():
            got = r[f"{name}/shard/{key}"]
            leaf = next((k for k in ("q", "s") if key.endswith(f"['{k}']")), None)
            dense = key[:-len("['q']")]
            aligned = {MIXER_IN_PROJ: "in_proj", MIXER + "['conv_w']": "conv",
                       MIXER + "['conv_b']": "conv"}.get(dense if leaf else key)
            if aligned:
                want = _head_slice(whole, jcfg, aligned, coord, world) \
                    if _splits(jcfg, world) else whole
            elif leaf == "q":
                want = _slice(whole, case["specs"][dense], coord, world)
            elif leaf == "s":
                q = case["w8"][dense + "['q']"]
                want = _slice(whole, _scale_spec(case["specs"][dense], q.ndim), coord, world)
            else:
                want = _slice(whole, case["specs"][key], coord, world)
            assert got.dtype == want.dtype and np.array_equal(got, want), key
            if leaf == "s":
                n_cut += got.shape != whole.shape
                n_whole += got.shape == whole.shape and \
                    r[f"{name}/shard/{dense}['q']"].shape != case["w8"][dense + "['q']"].shape
    # some scales are cut with their output dim, some stay whole under a cut q
    assert n_cut > 0 and n_whole > 0


def test_abstract_quantized_params_keep_the_segments():
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.quantized import apply
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        cfg = configs.smoke(arch)
        dense = api.abstract_params(cfg)["layers"]["mixer"]
        w8 = apply.abstract_quantized_params(cfg, min_size=0)["layers"]["mixer"]
        assert dense["in_proj"].segments
        assert w8["in_proj"]["q"].segments == w8["in_proj"]["s"].segments == \
            dense["in_proj"].segments
        assert w8["out_proj"]["q"].segments == dense["out_proj"].segments
        assert w8["out_proj"]["s"].segments == ()
        assert w8["in_proj"]["s"].logical == (None, "ffn")


LOCAL = r"""
import json
import math
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import base
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.quantized import apply

dryrun.open_fake_world(4)
mesh = make_mesh_compat((1, 4), ("data", "model"), device="meta")
out = {}
for arch in %r:
    cfg = configs.smoke(arch)
    with shd.use_mesh(mesh, tensor.serving_rules(mesh)):
        tree = tensor.local_tree(cfg, apply.abstract_quantized_params(cfg, min_size=0))
    out[arch] = {base.keystr(p): list(i.shape) for p, i in base.tree_items(tree)}
# the dry run's W8 serving variant: a split step's counted argument bytes
cfg = configs.smoke("qwen1.5-4b")
variant = {"quant": True, "rules": {"fsdp": ()}}
nbytes = lambda tree: sum(math.prod(i.shape) * i.dtype.itemsize
                          for _, i in base.tree_items(tree))
for kind in ("prefill", "decode"):
    shape = base.ShapeConfig(kind, 64, 4, kind)
    with shd.use_mesh(mesh, tensor.serving_rules(mesh)):
        params, cache, _ = dryrun.serve_trees(cfg, shape, mesh, tensor.serving_rules(mesh),
                                              variant)
    counter = dryrun.count_step(dryrun.build_step(cfg, shape, mesh, variant=variant))
    batch = dryrun._batch(cfg, shape, torch.device("meta"))
    out[kind] = {"args": counter.arg_bytes, "params": nbytes(params), "cache": nbytes(cache),
                 "inputs": sum(t.numel() * t.element_size() for t in batch.values()),
                 "int8": sum(i.dtype == torch.int8 for _, i in base.tree_items(params))}
print(json.dumps(out))
"""


def test_local_tree_of_the_w8_tree_gives_the_shards_shapes(worlds):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", LOCAL % (ARCHS,)], env=env,
                          capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    shapes = json.loads(proc.stdout.strip().splitlines()[-1])
    rank = worlds(4)["ranks"][1]
    for arch in ARCHS:
        got = {k: list(v.shape) for k, v in rank.items() if k.startswith(f"{arch}/shard/")}
        assert {f"{arch}/shard/{k}": v for k, v in shapes[arch].items()} == got
    # the dry run's W8 variant runs on the fake world, reading the W8 shards
    for kind in ("prefill", "decode"):
        r = shapes[kind]
        assert r["int8"] > 0 and r["args"] == r["params"] + r["cache"] + r["inputs"], kind


MOE = r"""
import dataclasses
import json
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import api, base
from repro_torch.models.base import ShapeConfig
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.quantized import apply
from repro_torch.serve.engine import Engine, ServeConfig

dryrun.open_fake_world(2)
cfg = dataclasses.replace(configs.smoke("granite-moe-1b-a400m"), compute_dtype="float32")
params = apply.quantize_params_for_serving(
    cfg, base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu"),
    min_size=0)
out = {}
mesh = make_mesh_compat((1, 2), ("data", "model"), device="cpu")
with shd.use_mesh(mesh, tensor.serving_rules(mesh)):
    engine = Engine(cfg, params, ServeConfig(max_len=8, max_new_tokens=1), device="cpu")
    cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(cfg, 1, 8)),
                           torch.Generator(), "cpu")
    try:
        api.prefill(cfg, engine.params, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                    cache)
    except TypeError as e:
        out["prefill"] = str(e)
    out["cut"] = sum(a.shape != b.shape for (_, a), (_, b) in
                     zip(base.tree_items(engine.params), base.tree_items(params)))
meta = make_mesh_compat((1, 2), ("data", "model"), device="meta")
step = dryrun.build_step(cfg, ShapeConfig("p", 8, 2, "prefill"), meta,
                         variant={"quant": True, "rules": {"fsdp": ()}})
try:
    step()
except TypeError as e:
    out["dryrun"] = str(e)
print(json.dumps(out))
"""


@pytest.mark.parametrize("split", [False, True])
def test_w8_moe_still_raises(split):
    """A W8 MoE raises the unmeshed layer's error, split over 2 or not:
    split, on a fake world of 2 ranks (a subprocess), at the prefill on
    the shards `Engine` cut and at the dry run's W8 variant's step."""
    from repro_torch import configs
    from repro_torch.models import api, base
    from repro_torch.quantized import apply
    cfg = dataclasses.replace(configs.smoke("granite-moe-1b-a400m"), compute_dtype="float32")
    params = apply.quantize_params_for_serving(
        cfg, base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu"),
        min_size=0)
    cache = base.tree_init(api.abstract_cache(cfg, 1, 8), torch.Generator(), "cpu")
    with pytest.raises(TypeError) as err:
        api.prefill(cfg, params, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cache)
    assert "W8 expert weights are not served" in str(err.value)
    if not split:
        return
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", MOE], env=env, capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["cut"] > 0
    assert got.get("prefill") == got.get("dryrun") == str(err.value)


def test_dryrun_command_line_counts_the_w8_serving_variant(tmp_path):
    """`launch.dryrun --serve-w8` counts qwen2-72b's decode_32k on the 16 x
    16 fake world from the W8 shards: about a quarter of the fp32 cell's
    parameter bytes a rank, with the same fallbacks."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    recs = {}
    for flag in ("", "--serve-w8"):
        path = tmp_path / f"dry{flag}.json"
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                               "qwen2-72b", "--shape", "decode_32k", "--out", str(path),
                               *([flag] if flag else [])],
                              env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        (recs[flag],) = json.loads(path.read_text())
        assert recs[flag]["ok"] and recs[flag]["rows_per_rank"] == 8
    fp32, w8 = recs[""], recs["--serve-w8"]
    assert 0.24 < w8["param_bytes"] / fp32["param_bytes"] < 0.26
    assert w8["fallbacks"] == fp32["fallbacks"]
    assert w8["peak_mem_per_device"] < fp32["peak_mem_per_device"]
