"""The ssm and hybrid families served split over a model axis above 1
(`parallel/tensor.py`, `layers/mamba2.py`) across gloo ranks on the CPU,
held to the JAX package's unmeshed path.

Two worlds are started as processes (`tests/_tp_ssm_child.py`, which
imports torch and `repro_torch` only; its group comes from a `FileStore`
in a temporary directory; every spawn is killed at its timeout): 2 ranks
on a (1, 2) (data, model) mesh and 4 ranks on (1, 4). Each serves, at
the smoke size in fp32, mamba2-2.7b (8 heads, 1 group) and zamba2-2.7b
(its shared block's 4 heads, 4 kv heads and ffn split too: the KV cache
by kv heads), and three configs derived from mamba2's: 2 groups (one a
rank under 2; under 4 each shared by two ranks), 4 groups (two a rank
under 2, one under 4) and 6 heads (3 a rank under 2; whole under 4, as
6 % 4 != 0). Per world and config:

* prefill's last logits and those of 4 greedy decode steps within 1e-5
  of the largest |logit| of the reference's `api.prefill` and
  `decode_step` on the same weights and prompts, on both SSD routes (the
  `ssd_scan` op and the chunked plain route), and the greedy tokens
  equal (also those of `Engine.generate` under the mesh);
* each rank's parameter shard bitwise equal to its slice: `in_proj`,
  `conv_w` and `conv_b` the head-aligned one (`_head_slice`: rank r of m
  holds heads [r H/m, (r + 1) H/m), their columns of z, x and dt and the
  B and C columns of the groups h // (H/G) of those heads); every other
  leaf (`out_proj`, the per-head vectors, the norms, the embedding, the
  shared block) the slice the reference's `sharding.spec` gives its
  model coordinate under the serving rules; a mixer that does not split
  whole. The fallbacks are the reference's, entry for entry, and the
  port's own ("ssm_heads", 6, ...) for each mixer leaf that stays whole;
* `tensor.gather_leaf` of every rank's shards the whole leaf, bitwise;
* each rank's cache after prefill and after each decode step within
  1e-5 of the largest magnitude of the matching slice of the port's
  unmeshed cache: the SSM cache and zamba2's KV cache by the reference's
  spec, the conv cache head-aligned;
* with autograd on (the collectives' backward, which the training slice
  will run), layer 0's split mixer: its output and its input's gradient
  within 1e-5 of the whole mixer's on every rank, and each mixer leaf's
  gradient, summed over the ranks at the places each rank's shard holds
  (a whole or shared leaf gets only the rank's heads' part), within
  1e-5 of the whole mixer's (a mixer that does not split: each rank's).

Weights are drawn with numpy from a seed, at the reference's init scales
(every leaf random, biases and norm scales too); they cross into the
port with `models.convert.from_jax_params`.

And on a fake world of 4 ranks on `meta` (a subprocess: the group is
process-wide): the counted argument bytes of a split prefill and decode
step equal the shards' and the cache slice's sizes plus the inputs' (a
prefill reads only zamba2's KV cache: it builds the SSM cache; mamba2's
decode step reads no position), and
their collectives equal a formula (`tests/_tp_formula.py`
`ssm_split_collectives`: two all-reduces a mixer, zamba's shared block
as the dense layers); the split path's FLOPs, bytes, argument and
collective bytes lie on one line in the layer count (a 2048-token
prefill too) through the dry run's two analysis depths.
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

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import base as jbase
from repro.parallel import sharding as jshd

from _gloo_world import spawn
from _tp_formula import ssm_split_collectives
from test_torch_tp import FakeMesh, _slice, _weights

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_tp_ssm_child.py")
TIMEOUT = 240
TOL = 1e-5
B, P, STEPS, MAX_LEN = 2, 8, 4, 16
ROUTES = ("kernel", "chunked")
CASES = [{"name": "mamba2-2.7b", "arch": "mamba2-2.7b", "over": {}},
         {"name": "zamba2-2.7b", "arch": "zamba2-2.7b", "over": {}},
         {"name": "mamba2-g2", "arch": "mamba2-2.7b", "over": {"ssm_groups": 2}},
         {"name": "mamba2-g4", "arch": "mamba2-2.7b", "over": {"ssm_groups": 4}},
         {"name": "mamba2-h6", "arch": "mamba2-2.7b", "over": {"d_model": 48}}]
WORLDS = (2, 4)
WORLD_CASES = [(w, c["name"]) for w in WORLDS for c in CASES]
# the leaves cut head-aligned, and their segments: (kind, width) a unit
HEAD_ALIGNED = ("in_proj", "conv_w", "conv_b")


def _jcfg(case: dict):
    return dataclasses.replace(jconfigs.smoke(case["arch"]), compute_dtype="float32",
                               **case["over"])


def _splits(jcfg, m: int) -> bool:
    H, G = jcfg.ssm_heads, jcfg.ssm_groups
    return H % m == 0 and (G % m == 0 or m % G == 0)


def _segments(jcfg, leaf: str) -> list:
    P, N = jcfg.ssm_headdim, jcfg.ssm_state
    xbc = [("heads", P), ("groups", N), ("groups", N)]
    return {"in_proj": [("heads", P)] + xbc + [("heads", 1)], "conv": xbc}[
        "in_proj" if leaf == "in_proj" else "conv"]


def _head_slice(a: np.ndarray, jcfg, leaf: str, r: int, m: int) -> np.ndarray:
    """Rank r of m's head-aligned slice of a mixer leaf along its last
    axis: per segment, heads [r H/m, (r + 1) H/m) or the groups
    [h0 // (H/G), (h1 - 1) // (H/G) + 1) of those heads, each unit
    `width` indices."""
    H, G = jcfg.ssm_heads, jcfg.ssm_groups
    h0, h1 = r * H // m, (r + 1) * H // m
    g0, g1 = h0 // (H // G), (h1 - 1) // (H // G) + 1
    parts, off = [], 0
    for kind, width in _segments(jcfg, leaf):
        n, lo, hi = (H, h0, h1) if kind == "heads" else (G, g0, g1)
        parts.append(a[..., off + lo * width:off + hi * width])
        off += n * width
    return np.concatenate(parts, axis=-1)


def _reference(jcfg, jp, prompts) -> dict:
    """The reference's unmeshed prefill and STEPS greedy decode steps."""
    cache = jbase.tree_init(japi.abstract_cache(jcfg, B, MAX_LEN), jax.random.PRNGKey(0))
    logits, cache = jax.jit(functools.partial(japi.prefill, jcfg))(
        jp, {"tokens": jnp.asarray(prompts)}, cache)
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


def _specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(k): s for k, s in flat}


@functools.lru_cache(maxsize=None)
def _case_inputs(i: int) -> dict:
    """A case's weights, prompts and reference run (the same in every world)."""
    case = CASES[i]
    jcfg = _jcfg(case)
    keys, treedef, leaves = _weights(jcfg, seed=200 + i)
    jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
    prompts = np.random.default_rng(300 + i).integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    return {"jcfg": jcfg, "keys": keys, "leaves": leaves, "prompts": prompts,
            "ref": _reference(jcfg, jp, prompts)}


def _world(world: int, d: Path) -> dict:
    """Run the reference on every case, hand the inputs to a world of
    `world` ranks, and gather both sides."""
    cases = {}
    for i, case in enumerate(CASES):
        c = _case_inputs(i)
        jcfg = c["jcfg"]
        np.savez(d / f"{case['name']}.npz", prompts=c["prompts"],
                 **{f"w/{k}": a for k, a in zip(c["keys"], c["leaves"])})
        with jshd.use_mesh(FakeMesh({"data": 1, "model": world}), {"batch": ("data",),
                                                                    "fsdp": ()}):
            pspecs = _specs(jbase.tree_specs(japi.abstract_params(jcfg)))
            fallbacks = jshd.fallbacks()
            cspecs = _specs(jbase.tree_specs(japi.abstract_cache(jcfg, B, MAX_LEN)))
        cases[case["name"]] = {
            "jcfg": jcfg, "ref": c["ref"], "weights": dict(zip(c["keys"], c["leaves"])),
            "specs": pspecs, "cache_specs": cspecs,
            "fallbacks": json.loads(json.dumps(fallbacks))}
    (d / "cases.json").write_text(json.dumps(
        [dict(c, max_len=MAX_LEN, steps=STEPS) for c in CASES]))
    return {"cases": cases, "ranks": spawn(CHILD, world, d, TIMEOUT, prefix="tp_")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """World size -> its results, each world run once, when first asked."""
    made: dict = {}

    def get(world: int) -> dict:
        if world not in made:
            made[world] = _world(world, tmp_path_factory.mktemp(f"tpssm{world}"))
        return made[world]

    return get


def _mixer_leaf(key: str) -> str | None:
    """The mixer leaf's name of a keystr (None for other leaves)."""
    parts = key.strip("[]'").split("']['")
    return parts[-1] if "mixer" in parts else None


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_split_logits_match_the_reference(worlds, world, name):
    w = worlds(world)
    ref = w["cases"][name]["ref"]
    for r in w["ranks"]:
        for i in range(STEPS + 1):
            want = ref[f"logits{i}"]
            bound = TOL * np.abs(want).max()
            for side in (*ROUTES, "plain"):
                got = r[f"{name}/{side}/logits{i}"]
                assert got.shape == want.shape, (side, i)
                assert np.abs(got - want).max() <= bound, (side, i)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_split_greedy_tokens_equal_the_reference(worlds, world, name):
    w = worlds(world)
    ref = w["cases"][name]["ref"]
    want = np.stack([ref[f"tokens{i}"] for i in range(STEPS + 1)], axis=1)
    for r in w["ranks"]:
        for route in ROUTES:
            got = np.stack([r[f"{name}/{route}/tokens{i}"] for i in range(STEPS + 1)], axis=1)
            np.testing.assert_array_equal(got, want, err_msg=route)
        np.testing.assert_array_equal(r[f"{name}/generate"], want)


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_parameter_shards_are_their_slices(worlds, world, name):
    w = worlds(world)
    case = w["cases"][name]
    jcfg = case["jcfg"]
    split = _splits(jcfg, world)
    n_cut = 0
    for r in w["ranks"]:
        coord = int(r[f"{name}/coordinate"])
        for key, whole in case["weights"].items():
            leaf = _mixer_leaf(key)
            if leaf in HEAD_ALIGNED:
                want = _head_slice(whole, jcfg, leaf, coord, world) if split else whole
            elif leaf == "out_proj" and not split:
                want = whole
            else:
                want = _slice(whole, case["specs"][key], coord, world)
            got = r[f"{name}/shard/{key}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), key
            n_cut += leaf is not None and got.shape != whole.shape
        own = [["ssm_heads", jcfg.ssm_heads, ["model"], None]] * (0 if split else 4)
        got = json.loads(str(r[f"{name}/fallbacks"]))
        assert [f for f in got if not f[0].startswith("ssm_")] == case["fallbacks"]
        assert [f for f in got if f[0].startswith("ssm_")] == own
    assert (n_cut > 0) == split


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_gather_leaf_gives_every_whole_leaf_back(worlds, world, name):
    for r in worlds(world)["ranks"]:
        assert json.loads(str(r[f"{name}/gather_differs"])) == []


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_cache_shards_are_slices_of_the_unmeshed_cache(worlds, world, name):
    w = worlds(world)
    case = w["cases"][name]
    jcfg = case["jcfg"]
    split = _splits(jcfg, world)
    for r in w["ranks"]:
        coord = int(r[f"{name}/coordinate"])
        for i in range(STEPS + 1):
            prefix = f"{name}/plain/cache{i}/"
            keys = [k[len(prefix):] for k in r if k.startswith(prefix)]
            assert len(keys) == (4 if jcfg.family == "hybrid" else 2)
            for key in keys:
                plain = r[prefix + key]
                if key.endswith("['conv']"):
                    want = _head_slice(plain, jcfg, "conv", coord, world) if split else plain
                else:
                    want = _slice(plain, case["cache_specs"][key], coord, world)
                for route in ROUTES:
                    got = r[f"{name}/{route}/cache{i}/{key}"]
                    assert got.shape == want.shape, (key, i, route)
                    assert (got.shape != plain.shape) == (split or "['kv']" in key), key
                    assert np.abs(got - want).max() <= TOL * np.abs(plain).max(), (key, i)


def _placed(g: np.ndarray, jcfg, leaf: str, r: int, m: int, whole_shape) -> np.ndarray:
    """Rank r's gradient of a layer's mixer leaf, put at the places of the
    whole leaf its shard holds (zeros elsewhere)."""
    out = np.zeros(whole_shape, g.dtype)
    if g.shape == tuple(whole_shape):
        out[...] = g
    elif leaf in HEAD_ALIGNED:
        idx = _head_slice(np.arange(whole_shape[-1])[None], jcfg, leaf, r, m)[0]
        out[..., idx] = g
    else:                                     # out_proj: the spec's rows
        n = g.shape[0]
        out[r * n:(r + 1) * n] = g
    return out


@pytest.mark.parametrize("world,name", WORLD_CASES)
def test_split_mixer_gradients_sum_to_the_whole_mixer(worlds, world, name):
    w = worlds(world)
    jcfg = w["cases"][name]["jcfg"]
    ranks = w["ranks"]
    plain = {k[len(f"{name}/grad/plain/"):]: v for k, v in ranks[0].items()
             if k.startswith(f"{name}/grad/plain/")}
    for r in ranks:
        for k in ("out", "x"):
            got = r[f"{name}/grad/split/{k}"]
            assert np.abs(got - plain[k]).max() <= TOL * np.abs(plain[k]).max(), k
    leaves = [k for k in plain if k not in ("out", "x")]
    assert len(leaves) == 8
    for leaf in leaves:
        bound = TOL * np.abs(plain[leaf]).max()
        if not _splits(jcfg, world):                 # every rank runs the whole mixer
            for r in ranks:
                assert np.abs(r[f"{name}/grad/split/{leaf}"] - plain[leaf]).max() <= bound
            continue
        total = sum(_placed(r[f"{name}/grad/split/{leaf}"], jcfg, leaf,
                            int(r[f"{name}/coordinate"]), world, plain[leaf].shape)
                    for r in ranks)
        assert np.abs(total - plain[leaf]).max() <= bound, leaf


def test_derived_configs_take_the_cuts_they_were_made_for():
    """The groups a rank holds and the whole mixer, by the formula."""
    cfgs = {c["name"]: _jcfg(c) for c in CASES}
    g2, g4, h6 = cfgs["mamba2-g2"], cfgs["mamba2-g4"], cfgs["mamba2-h6"]
    assert (g2.ssm_heads, g2.ssm_groups, g4.ssm_groups, h6.ssm_heads) == (8, 2, 4, 6)
    N = g2.ssm_state
    width = lambda jcfg, r, m: _head_slice(  # noqa: E731
        np.zeros((1, jcfg.conv_dim)), jcfg, "conv", r, m).shape[-1] - jcfg.d_inner // m
    assert [width(g2, r, 2) for r in range(2)] == [2 * N] * 2          # one group a rank
    assert [width(g2, r, 4) for r in range(4)] == [2 * N] * 4          # each shared by two
    assert [width(g4, r, 2) for r in range(2)] == [4 * N] * 2          # two a rank
    assert [width(g4, r, 4) for r in range(4)] == [2 * N] * 4
    assert _splits(h6, 2) and not _splits(h6, 4)


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
nbytes = lambda tree: sum(math.prod(i.shape) * i.dtype.itemsize
                          for _, i in base.tree_items(tree))
for arch in ("mamba2-2.7b", "zamba2-2.7b"):
    cfg = configs.smoke(arch)
    for kind in ("prefill", "decode"):
        shape = base.ShapeConfig(kind, 64, 4, kind)
        with shd.use_mesh(mesh, tensor.serving_rules()):
            ptree = tensor.local_tree(cfg, api.abstract_params(cfg))
            ctree = tensor.local_tree(cfg, api.abstract_cache(cfg, 4, 64))
        step = dryrun.build_step(cfg, shape, mesh, variant={"rules": tensor.serving_rules()})
        counter = dryrun.count_step(step)
        batch = dryrun._batch(cfg, shape, torch.device("meta"))
        out[f"{arch}/{kind}"] = {
            "params": nbytes(ptree), "cache": nbytes(ctree), "args": counter.arg_bytes,
            "kv_cache": nbytes(ctree.get("kv", {})),
            "whole_params": nbytes(api.abstract_params(cfg)),
            "inputs": {k: t.numel() * t.element_size() for k, t in batch.items()},
            "coll": counter.summary()["breakdown"]}
# the split path's counts at the dry run's analysis depths and beyond
for arch in ("mamba2-2.7b", "zamba2-2.7b"):
    L1, L2 = dryrun.analysis_layers(configs.smoke(arch))
    for kind, S in (("prefill", 64), ("decode", 64), ("prefill", 2048)):
        shape = base.ShapeConfig(kind, S, 4, kind)
        rows = []
        for L in (L1, L2, 5 * L2 - 4 * L1):
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
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        cfg = configs.smoke(arch)
        for kind in ("prefill", "decode"):
            r = rec[f"{arch}/{kind}"]
            assert r["params"] < r["whole_params"], (arch, kind)
            # a prefill reads no SSM cache (it builds one), only a KV cache;
            # mamba2's decode step reads no position
            cache = r["cache"] if kind == "decode" else r["kv_cache"]
            inputs = sum(n for k, n in r["inputs"].items()
                         if k != "pos" or cfg.family == "hybrid")
            assert r["args"] == r["params"] + cache + inputs, (arch, kind)
            want = ssm_split_collectives(cfg, kind, 4, 64, 4)
            assert {k: r["coll"].get(k, 0) for k in want} == want, (arch, kind)
        for kind in ("prefill64", "decode64", "prefill2048"):
            # FLOPs, bytes, argument and collective bytes on one line in the
            # layer count, through the dry run's two analysis depths
            (l1, *a), (l2, *b), (l3, *c) = rec[f"{arch}/{kind}/depths"]
            for x, y, z in zip(a, b, c):
                assert y > x and (y - x) * (l3 - l1) == (z - x) * (l2 - l1), (arch, kind)
