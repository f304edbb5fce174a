"""Sequence parallelism between layers (`parallel/tensor.py` `gather_seq`,
`scatter_seq`, `seq_range`; ROADMAP.md A item 4) across gloo ranks on the
CPU, held to the JAX package's unmeshed path and to one process.

Serving: worlds of 2, 3 and 4 ranks on a (1, m) (data, model) mesh, each
rank a process (`tests/_sp_child.py`: torch and `repro_torch` only; a
`FileStore` in a temporary directory; killed at its timeout), at the
smoke size in fp32:

* (1, 2): qwen1.5-4b (heads and vocab split), granite-moe (experts
  split), mamba2 and zamba2 in "mixed" (the mixer split by heads on the
  gathered sequence);
* (1, 3): the query-sequence split. qwen1.5-4b's 4 heads and 512-entry
  vocab stay whole under 3 and its ffn of 96 splits; gemma-2b (kv 1, a
  tied whole vocab), qwen2-vl-2b with its M-RoPE positions and image
  patches, granite-moe (8 experts whole), mamba2 and zamba2 (8 heads:
  the mixer whole) in "mixed" and in "heads"; a 9-token prompt divides
  3, and qwen1.5-4b's 8-token prompt does not (the fallback);
* (1, 4): a 2,048-token flash prefill on a query slice of 512 (a
  qwen1.5-4b derived to 6 heads, 6 kv heads and a 510-entry vocab, which
  stay whole), and gemma-2b (heads split over a whole kv head, the cache
  by positions).

Per world and case: prefill's last logits and those of 4 greedy decode
steps within 1e-5 of the largest |logit| of the reference's `api.prefill`
and `decode_step` on the same weights, prompts and extras, and the greedy
tokens equal, for the split run and for one process; `api.forward`'s
logits of every position (B, P, V) within 1e-5 of one process's, a whole
vocab's gathered along the sequence; every attention and
mixer input of the split prefill holds P/m positions where the prompt
divides m (in "mixed"), all P elsewhere; a prompt that does not divide
is recorded in `fallbacks()` entry for entry as the reference's
`sharding.spec` records its ("batch", "seq", None) hidden state, as is
each decode step's S = 1, and a divided prompt is not; in "heads" the
logits equal bitwise those of the same ranks with the rules' "seq"
cleared (no sequence split anywhere). `gather_seq` and `scatter_seq` on
small tensors equal one process: outputs and input gradients.

Training: two AdamW steps (remat "full", `tests/_tp_train_child.py`)
on (1, 3) (qwen1.5-4b, mamba2, zamba2 and granite-moe at 12 tokens: the
query split, a whole vocab's loss summed over the model group, a whole
mixer and whole experts, and the step's sum of the leaves held whole)
and (2, 2) (qwen1.5-4b: heads and vocab split under FSDP; mamba2 in
"heads"): the losses within 1e-6 relative of the reference's steps (the
`tp` job of `tests/_pinned_parent.py`) and of one process, the grad norms
of one process's, the parameters after the steps and the first batch's
gradients within 1e-6 of their largest magnitude (`test_torch_tp_train`'s
holds). The key bias `bk` is left out of both parameter comparisons
(`NOISE`): its exact gradient is zero, as softmax ignores a constant a
query, so AdamW turns the rounding left in it into whole steps, and the
query split's three partial sums round otherwise than one process's;
its gradient is held with every other leaf's.

On a fake world of 4 ranks on `meta` (a subprocess): each layer's
checkpointed input of a train step is (B, S/4, D) (qwen1.5-4b; mamba2
in "mixed"), (B, S, D) in "heads", and the step's collectives equal
`_tp_formula`'s; a flash prefill split by queries counts
`split_collectives`'s.
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

from _gloo_world import spawn
from _tp_formula import split_collectives, ssm_train_collectives, train_collectives
from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.models import base as jbase
from repro.parallel import sharding as jshd
from test_torch_tp import FakeMesh, _weights
from test_torch_tp_train import NOISE, SHARE, _close, train_worlds

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_sp_child.py")
TIMEOUT = 240
TOL = 1e-5
STEPS = 4
FLASH = {"n_heads": 6, "n_kv_heads": 6, "vocab": 510}
HEADS = {"ssm_shard": "heads"}


def _case(name, arch, P, B=2, over=None, flags=None, whole=False) -> dict:
    return {"name": name, "arch": arch, "P": P, "B": B, "over": over or {},
            "flags": flags or {}, "whole": whole, "steps": STEPS, "max_len": P + 8}


SERVE = {
    2: [_case("qwen", "qwen1.5-4b", 8), _case("granite", "granite-moe-1b-a400m", 8),
        _case("mamba2", "mamba2-2.7b", 8), _case("zamba2", "zamba2-2.7b", 8)],
    3: [_case("qwen", "qwen1.5-4b", 9), _case("qwen-ragged", "qwen1.5-4b", 8),
        _case("gemma", "gemma-2b", 9), _case("qwen2-vl", "qwen2-vl-2b", 9),
        _case("granite", "granite-moe-1b-a400m", 9), _case("mamba2", "mamba2-2.7b", 9),
        _case("mamba2-heads", "mamba2-2.7b", 9, flags=HEADS, whole=True),
        _case("zamba2", "zamba2-2.7b", 9),
        _case("zamba2-heads", "zamba2-2.7b", 9, flags=HEADS, whole=True)],
    4: [_case("flash", "qwen1.5-4b", 2048, B=1, over=FLASH), _case("gemma", "gemma-2b", 8)],
}
SERVE_CASES = [(w, c["name"]) for w, cases in SERVE.items() for c in cases]


def _jcfg(case: dict):
    return dataclasses.replace(jconfigs.smoke(case["arch"]), compute_dtype="float32",
                               **case["over"])


def _reference(jcfg, jp, prompts, extras, case) -> dict:
    """The reference's unmeshed prefill and STEPS greedy decode steps."""
    B, P = prompts.shape
    cache = jbase.tree_init(japi.abstract_cache(jcfg, B, case["max_len"]), jax.random.PRNGKey(0))
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


def _seq_fallback(jcfg, case, world) -> list:
    """What the reference records for the case's (B, P, D) hidden state
    under a model axis of `world` (nothing where P divides it)."""
    with jshd.use_mesh(FakeMesh({"data": 1, "model": world}), {"batch": ("data",)}):
        jshd.spec((case["B"], case["P"], jcfg.d_model), ("batch", "seq", None))
        return json.loads(json.dumps(jshd.fallbacks()))


def serve_world(world: int, d: Path, seed: int = 300) -> dict:
    cases = {}
    for i, case in enumerate(SERVE[world]):
        jcfg = _jcfg(case)
        keys, treedef, leaves = _weights(jcfg, seed=seed + i)
        jp = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
        batch = jpipeline.make_batch(jcfg, jbase.ShapeConfig("sp", case["P"], case["B"],
                                                             "prefill"), 0)
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "targets", "loss_mask")}
        np.savez(d / f"{case['name']}.npz", prompts=batch["tokens"],
                 **{f"w/{k}": a for k, a in zip(keys, leaves)},
                 **{f"x/{k}": v for k, v in extras.items()})
        cases[case["name"]] = {"ref": _reference(jcfg, jp, batch["tokens"], extras, case),
                               "seq": _seq_fallback(jcfg, case, world),
                               "step": _seq_fallback(jcfg, dict(case, P=1), world)}
    (d / "cases.json").write_text(json.dumps(SERVE[world]))
    return {"cases": cases, "ranks": spawn(CHILD, world, d, TIMEOUT, prefix="sp_")}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    made: dict = {}

    def get(world: int) -> dict:
        if world not in made:
            made[world] = serve_world(world, tmp_path_factory.mktemp(f"sp{world}"))
        return made[world]

    return get


def _spec(world: int, name: str) -> dict:
    return next(c for c in SERVE[world] if c["name"] == name)


def _splits(case: dict, world: int) -> bool:
    return case["P"] % world == 0 and case["flags"].get("ssm_shard") != "heads"


@pytest.mark.parametrize("world,name", SERVE_CASES)
def test_split_serving_matches_the_reference(worlds, world, name):
    w = worlds(world)
    ref = w["cases"][name]["ref"]
    lead = w["ranks"][0]
    for i in range(STEPS + 1):
        want = ref[f"logits{i}"]
        bound = TOL * np.abs(want).max()
        for r, side in [(r, "split") for r in w["ranks"]] + [(lead, "plain")]:
            got = r[f"{name}/{side}/logits{i}"]
            assert got.shape == want.shape, (side, i)
            assert np.abs(got - want).max() <= bound, (side, i)
            np.testing.assert_array_equal(r[f"{name}/{side}/tokens{i}"], ref[f"tokens{i}"])


@pytest.mark.parametrize("world,name", SERVE_CASES)
def test_split_forward_gives_every_position(worlds, world, name):
    w = worlds(world)
    want = w["ranks"][0][f"{name}/plain/forward"]
    for r in w["ranks"]:
        got = r[f"{name}/split/forward"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("world,name", SERVE_CASES)
def test_layers_hold_this_ranks_positions(worlds, world, name):
    """Every attention and mixer input of the split prefill holds P/m
    positions where the sequence splits, P elsewhere; one process's all P."""
    case = _spec(world, name)
    w = worlds(world)
    n = case["P"] // world if _splits(case, world) else case["P"]
    for r in w["ranks"]:
        seen = r[f"{name}/split/hidden"]
        assert len(seen) > 0 and set(seen.tolist()) == {n}
    assert set(w["ranks"][0][f"{name}/plain/hidden"].tolist()) == {case["P"]}


@pytest.mark.parametrize("world,name", SERVE_CASES)
def test_sequence_fallbacks_are_the_references(worlds, world, name):
    """A prompt that does not divide the axis is recorded once, as the
    reference's spec records it; each decode step's S = 1 too."""
    case, w = _spec(world, name), worlds(world)
    want = w["cases"][name]
    for r in w["ranks"]:
        got = [f for f in json.loads(str(r[f"{name}/fallbacks"])) if f[0] == "seq"]
        assert got == want["seq"] + want["step"] * STEPS
    assert (want["seq"] == []) == (case["P"] % world == 0)
    assert want["step"] == [["seq", 1, ["model"], None]]


@pytest.mark.parametrize("name", ["mamba2-heads", "zamba2-heads"])
def test_heads_mode_keeps_the_hidden_state_whole(worlds, name):
    """Under ssm_shard="heads" the split ranks' logits equal bitwise those
    of the same ranks with no sequence split at all."""
    for r in worlds(3)["ranks"]:
        for i in range(STEPS + 1):
            np.testing.assert_array_equal(r[f"{name}/split/logits{i}"],
                                          r[f"{name}/whole/logits{i}"])
        assert set(r[f"{name}/whole/hidden"].tolist()) == {9}


@pytest.mark.parametrize("world", list(SERVE))
def test_gather_and_scatter_seq_equal_one_process(worlds, world):
    for r in worlds(world)["ranks"]:
        units = {k: float(v) for k, v in r.items() if k.startswith("unit/")}
        assert len(units) == 4 and max(units.values()) <= 1e-6, units


# -- two AdamW steps ------------------------------------------------------------

TRAIN_BASE = {"seq": 12, "batch": 4, "accum": 2, "lr": 1e-3, "data_seed": 5}
TRAIN = {(1, 3): [{"name": "qwen", "arch": "qwen1.5-4b", "over": {}},
                  {"name": "mamba2", "arch": "mamba2-2.7b", "over": {}},
                  {"name": "zamba2", "arch": "zamba2-2.7b", "over": {}},
                  {"name": "granite", "arch": "granite-moe-1b-a400m", "over": {}}],
         (2, 2): [{"name": "qwen", "arch": "qwen1.5-4b", "over": {}},
                  {"name": "mamba2-heads", "arch": "mamba2-2.7b", "over": {},
                   "flags": HEADS}]}
TRAIN_ALL = {c["name"]: dict(TRAIN_BASE, **c) for cases in TRAIN.values() for c in cases}
TRAIN_CASES = [(w, c["name"]) for w, cases in TRAIN.items() for c in cases]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_worlds(tmp_path_factory.mktemp("sp_train"), TRAIN_ALL, TRAIN, seed=400)


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_split_steps_match_the_reference(trained, world, name):
    lead, ref = trained["ranks"][world][0], trained["ref"][name]
    for r in trained["ranks"][world]:
        np.testing.assert_allclose(r[f"{name}/loss"], ref["loss"], rtol=1e-6, atol=0)
    assert _close(lead, f"{name}/whole", ref["params"], ref["gmin"], NOISE) >= SHARE


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_split_steps_match_one_process(trained, world, name):
    lead, ref = trained["ranks"][world][0], trained["ref"][name]
    for r in trained["ranks"][world]:
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(r[f"{name}/{k}"], lead[f"{name}/plain/{k}"], rtol=1e-6,
                                       atol=0)
    _close(lead, f"{name}/whole", {k: lead[f"{name}/plain/{k}"] for k in ref["params"]},
           ref["gmin"], NOISE)
    grads = {k: lead[f"{name}/grad/plain/{k}"] for k in ref["params"]}
    scale = max(np.abs(v).max() for v in grads.values())
    for k, v in grads.items():
        assert np.abs(lead[f"{name}/grad/whole/{k}"] - v).max() <= 1e-6 * scale, k


# -- a fake world of 4 ranks, on meta ---------------------------------------------

COUNTS = r"""
import dataclasses, json
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import base, mamba, runtime, transformer, zamba

dryrun.open_fake_world(4)
saved = []
def recording(remat_call):
    def call(remat, fn, *args):
        saved.append(list(args[2].shape))
        return remat_call(remat, fn, *args)
    return call
for mod in (transformer, mamba, zamba):
    mod.remat_call = recording(mod.remat_call)
out = {}
mesh = make_mesh_compat((1, 4), ("data", "model"), device="meta")
shape = base.ShapeConfig("t", 64, 8, "train", accum=2)
for name, arch, flags in (("qwen", "qwen1.5-4b", {}), ("mamba2", "mamba2-2.7b", {}),
                          ("mamba2-heads", "mamba2-2.7b", {"ssm_shard": "heads"})):
    saved.clear()
    with runtime.with_flags(**flags):
        s = dryrun.count_step(dryrun.build_step(configs.smoke(arch), shape, mesh)).summary()
    out[name] = {"saved": list(saved), "coll": s["breakdown"]}
cfg = dataclasses.replace(configs.smoke("qwen1.5-4b"), n_heads=6, n_kv_heads=6, vocab=510)
step = dryrun.build_step(cfg, base.ShapeConfig("p", 2048, 4, "prefill"), mesh,
                         variant={"rules": {"batch": ("data",), "fsdp": ()}})
out["flash"] = {"coll": dryrun.count_step(step).summary()["breakdown"]}
print(json.dumps(out))
"""


def test_saved_inputs_and_collectives_on_a_fake_world():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", COUNTS], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro_torch import configs
    qwen, mamba2 = configs.smoke("qwen1.5-4b"), configs.smoke("mamba2-2.7b")
    # two microbatches of 4 rows, each layer's input checkpointed once
    assert rec["qwen"]["saved"] == [[4, 16, 64]] * 2 * qwen.n_layers
    assert rec["mamba2"]["saved"] == [[4, 16, 64]] * 2 * mamba2.n_layers
    assert rec["mamba2-heads"]["saved"] == [[4, 64, 64]] * 2 * mamba2.n_layers
    kw = dict(data=1, model=4, batch=8, seq=64, accum=2)
    for name, want in (("qwen", train_collectives(qwen, **kw)),
                       ("mamba2", ssm_train_collectives(mamba2, **kw)),
                       ("mamba2-heads", ssm_train_collectives(mamba2, mode="heads", **kw))):
        got = rec[name]["coll"]
        assert {k: got.get(k, 0) for k in want} == want, name
    flash = dataclasses.replace(qwen, **FLASH)
    want = split_collectives(flash, "prefill", 4, 2048, 4)
    assert {k: rec["flash"]["coll"].get(k, 0) for k in want} == want
