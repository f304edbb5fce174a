"""The port's mesh paths across gloo ranks on the CPU, held to the JAX
package (and to the port's single-process paths).

Three worlds are started as processes (`tests/_mesh_child.py`, which
imports torch and `repro_torch` only; its group comes from a `FileStore`
in a temporary directory; every spawn is killed at its timeout). The
parent runs the JAX reference and passes inputs and results as files.

* 8 ranks: `moe_shardmap` on a 2x4 (data, model) mesh against
  `repro.layers.moe.moe` on the smoke granite-moe weights and inputs at
  capacity factor 4.0, where neither drops a pair (fp32: 1e-5 of the
  largest |out|; the reference's own test allows 2e-3); its aux losses
  equal the reference formula's pmean over model, then data (1e-6
  relative); its input gradient equals the plain `moe`'s (1e-5). The
  sharded stacked dispatch over 8 data ranks on the `torch` target,
  bit-exact with the unsharded dispatch, the port's `predict_quantized`
  and the reference's, with
  `dispatch_counts` moving as in `tests/test_netgen_serve.py`. A saved
  train state restored under a 2x4 mesh: each rank's shard equals the
  reference spec's slice of the saved array.
* 4 ranks: `compressed_psum` over "data": the new error equals the
  reference's `compress_decompress` error bit for bit, the sum is within
  1e-6 relative of the float64 sum of the reference's decoded values.
* 2 ranks: two trainer steps (accum 2) of gemma-2b, granite-moe-1b-a400m
  and qwen2-vl-2b at the smoke size in fp32, resumed from the
  reference's initial state, and two vlm train steps on batches whose
  loss mask gives the two ranks unequal token counts, each held

  - to the reference's train step (`repro.train.step`) on the same
    state and global batches: loss within 1e-6 relative; parameters
    within 1e-6 of their largest magnitude wherever the reference's
    gradient stayed above 1e-6 (100 x AdamW's eps of 1e-8) in both steps,
    which is at least 95% of them, and within 2 lr elsewhere. Below
    that an element's step, lr g / (|g| + eps), follows the fp32
    summation order of g: a few elements with |g| ~ 1e-8 move by up to
    ~5e-6 of the largest parameter, in one process as in two (CPU run
    of this file);
  - to the port's single-process steps: loss within 1e-6 relative,
    parameters within 1e-6 of their largest magnitude, but for one leaf
    held by its gradient (the vlm step's reduced gradients, within 1e-6
    of the largest |g| at every leaf) and not by its value: qwen2-vl's
    key bias `bk`, whose gradients run from ~4e-8 to ~1e-2 and so reach
    AdamW's eps, where the summation order of two ranks against one
    moves its step by a few per cent of lr (~1.7e-5 after two steps of
    lr 1e-3, against 1e-6 of the largest parameter, 2.1e-6). The
    trainer's parameters are held so where the reference's gradient
    stayed above 1e-6 in both steps, and within 2 lr elsewhere: the
    embedding rows of rare tokens reach AdamW's eps too, and over hash
    seeds 0-6 of the initial state (CPU runs of this file) their
    elements differed by up to 1.15e-6 of the largest parameter in two
    draws of seven.

  The initial state, the reference's steps and the one-process trainer
  are made in processes of their own, on one intra-op thread as the ranks
  run and with a fixed hash seed (tests/_pinned_parent.py): made in this
  process, the state followed its hash salt and the sums its thread
  count, and granite-moe's comparisons crossed their bounds on some runs
  and not on others.

  Also granite-moe's remat="full" gradients on the two ranks with the
  backward run on another thread, as autograd runs a CUDA backward on
  its device thread, so each layer's recompute runs where the forward's
  mesh and reduction group are not set: equal to one process's
  remat="none" gradients within 1e-6 of the largest |g|. And the
  launcher's --multi-pod raises its world-size error.

And in this process, on a one-rank CPU mesh: a restore under 1x1 whose
`full_tensor()` equals the save.
"""
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
import torch.distributed as dist

from _mesh_child import MOE_ARCH, TRAIN_ARCHS, flat, train_setup
from _pinned_parent import ENV as PINNED_ENV
from _pinned_parent import unpack
from repro import configs as jconfigs
from repro.core import quantize as jquantize
from repro.layers import moe as jmoe
from repro.models import base as jbase
from repro.optim import compression as jcompression
from repro.parallel import sharding as jshd
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import base
from repro_torch.parallel import sharding as shd
from repro_torch.train import step

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).with_name("_mesh_child.py")
PINNED = Path(__file__).with_name("_pinned_parent.py")
TIMEOUT = 240
LR = 1e-3           # train_setup's
EPS_REGIME = 1e-6   # |g| below 100 x AdamW's eps of 1e-8 (module doc)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _spawn(job: str, world: int, d: Path) -> list[dict]:
    """Run `job` on `world` gloo ranks; their outputs, by rank."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    logs = [open(d / f"{job}_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(CHILD), job, str(r), str(world), str(d)],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
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
        tails = "\n".join(f"--- rank {r}:\n" + (d / f"{job}_{r}.log").read_text()[-3000:]
                          for r in range(world))
        raise AssertionError(f"{job}: exit codes {[p.returncode for p in procs]}\n{tails}")
    return [dict(np.load(d / f"{job}_{r}.npz")) for r in range(world)]


# -- 8 ranks: moe_shardmap, the sharded stacked dispatch, restore -----------

def _moe_reference(cfg, p, x):
    """The reference's per-shard aux losses over a 2x4 mesh, averaged over
    model, then data (`repro/layers/moe_shardmap.py`'s pmeans)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    lbs, zls = np.zeros((2, 4)), np.zeros((2, 4))
    for di in range(2):
        xt = x[di * 2:(di + 1) * 2].reshape(-1, cfg.d_model)
        for m in range(4):
            t = xt[m * 8:(m + 1) * 8]
            logits = t @ p["router"]
            probs = jax.nn.softmax(logits, axis=-1)
            _, ids = jax.lax.top_k(probs, K)
            counts = jnp.zeros((E,)).at[ids.reshape(-1)].add(1.0)
            lbs[di, m] = E * jnp.sum(jnp.mean(probs, 0) * counts / t.shape[0])
            zls[di, m] = jnp.mean(jax.nn.logsumexp(logits, axis=-1) ** 2)
    return lbs.mean(1).mean(), zls.mean(1).mean()


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    d = tmp_path_factory.mktemp("eight")
    # moe_shardmap: the reference's smoke weights and (4, 16, D) inputs
    jcfg = jconfigs.smoke(MOE_ARCH)
    jp = jbase.tree_init(jmoe.moe_params(jcfg), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(size=(4, 16, jcfg.d_model)).astype(np.float32)
    np.savez(d / "moe_in.npz", x=x, **{k: np.asarray(v) for k, v in jp.items()})
    ref, _ = jmoe.moe(jcfg, jp, jnp.asarray(x), capacity_factor=4.0)
    jgrad = jax.grad(lambda x_: jmoe.moe(jcfg, jp, x_, capacity_factor=4.0)[0].sum())(x)
    # the stacked dispatch: two 64-16-10 nets, 11 images (8 + 3 slot rows)
    rng = np.random.default_rng(110)
    nets = {f"{v}{i}": rng.integers(-9, 10, size=s).astype(np.int32)
            for v in "ab" for i, s in enumerate(((64, 16), (16, 10)))}
    images = rng.integers(0, 256, size=(11, 64)).astype(np.uint8)
    np.savez(d / "dispatch_in.npz", x=images, **nets)
    answers = {v: np.asarray(jquantize.predict_quantized(
        jquantize.QuantizedNet(weights=[nets[f"{v}0"], nets[f"{v}1"]]))(images)) for v in "ab"}
    # restore: a granite-moe train state saved whole, and the reference's specs
    state = base.tree_init(step.abstract_state(configs.smoke(MOE_ARCH)),
                           torch.Generator().manual_seed(7), "cpu")
    ckpt.save(str(d / "ckpt"), 7, state)
    with jshd.use_mesh(FakeMesh({"data": 2, "model": 4}), {"batch": ("data",)}):
        specs = jbase.tree_specs(jstep.abstract_state(jconfigs.smoke(MOE_ARCH)))
    flat_specs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    (d / "restore_specs.json").write_text(json.dumps(
        {jax.tree_util.keystr(k): list(s) for k, s in flat_specs}))
    return {"ranks": _spawn("eight", 8, d), "ref": np.asarray(ref), "jgrad": np.asarray(jgrad),
            "answers": answers,
            "aux": _moe_reference(jcfg, jp, jnp.asarray(x)), "state": state}


def test_moe_shardmap_matches_the_reference(eight):
    ref, scale = eight["ref"], np.abs(eight["ref"]).max()
    lb, zl = eight["aux"]
    for r in eight["ranks"]:
        di = int(r["moe/data"])
        assert np.abs(r["moe/out"] - ref[di * 2:(di + 1) * 2]).max() <= 1e-5 * scale
        np.testing.assert_allclose(r["moe/lb"], lb, rtol=1e-6)
        np.testing.assert_allclose(r["moe/zl"], zl, rtol=1e-6)
        g = r["moe/grad"]
        assert np.abs(g - r["moe/plain_grad"]).max() <= 1e-5 * np.abs(g).max()
        assert np.abs(g - eight["jgrad"][di * 2:(di + 1) * 2]).max() <= 1e-5 * np.abs(g).max()


def test_sharded_stacked_dispatch_over_eight_data_ranks(eight):
    for r in eight["ranks"]:
        for v in "ab":
            want = r[f"dispatch/want_{v}"]
            np.testing.assert_array_equal(want, eight["answers"][v])    # the reference's
            for label in ("plain", "sharded", "after", "nodata"):
                np.testing.assert_array_equal(r[f"dispatch/{label}_{v}"], want, err_msg=label)
        # [single, stacked, sharded, fallback]
        assert r["dispatch/plain_counts"].tolist() == [0, 1, 0, 0]
        assert r["dispatch/sharded_counts"].tolist() == [0, 2, 1, 0]
        assert r["dispatch/after_counts"].tolist() == [0, 3, 1, 0]   # the single-device build
        assert r["dispatch/nodata_counts"].tolist() == [0, 1, 0, 0]  # no data axis: unsharded


def test_restore_reshards_under_a_2x4_mesh(eight):
    for r in eight["ranks"]:
        assert r["restore/bad"].tolist() == []
        assert int(r["restore/split_dims"]) > 0


def test_restore_under_a_1x1_mesh(tmp_path):
    from torch.distributed.tensor import DTensor
    state = base.tree_init(step.abstract_state(configs.smoke("gemma-2b")),
                           torch.Generator().manual_seed(1), "cpu")
    path = ckpt.save(str(tmp_path), 3, state)
    try:
        with shd.use_mesh(make_host_mesh(device="cpu"), {"batch": ("data",)}):
            got = ckpt.restore(path, step.abstract_state(configs.smoke("gemma-2b")),
                               device="cpu")
    finally:
        dist.destroy_process_group()
    for (p, a), (_, b) in zip(base.tree_items(got), base.tree_items(state)):
        assert isinstance(a, DTensor) and torch.equal(a.full_tensor(), b), base.keystr(p)


# -- 4 ranks: compressed_psum ------------------------------------------------

def test_compressed_psum_over_four_data_ranks(tmp_path):
    rng = np.random.default_rng(4)
    inputs = {}
    for r in range(4):
        inputs[f"x{r}"] = rng.normal(size=(5000,)).astype(np.float32)
        inputs[f"e{r}"] = (rng.normal(size=(5000,)) * 1e-3).astype(np.float32)
    np.savez(tmp_path / "psum_in.npz", **inputs)
    ranks = _spawn("psum", 4, tmp_path)
    ref = [jcompression.compress_decompress(jnp.asarray(inputs[f"x{r}"]),
                                            jnp.asarray(inputs[f"e{r}"])) for r in range(4)]
    want = np.sum([np.asarray(dec, np.float64) for dec, _ in ref], axis=0)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["err"], np.asarray(ref[r][1]))
        assert np.abs(out["total"] - want).max() <= 1e-6 * np.abs(want).max()


# -- 2 ranks: data-parallel training -----------------------------------------

def _vlm_batches():
    """Two qwen2-vl batches whose loss masks give rows (and so the two
    ranks' halves of each microbatch) unequal token counts."""
    cfg, shape, _, _ = train_setup("qwen2-vl-2b")
    rng = np.random.default_rng(9)
    out = {}
    for i in range(2):
        b = make_batch(cfg, shape, i, seed=21)
        b["loss_mask"] = (rng.random(b["loss_mask"].shape) < [[0.9], [0.2], [0.6], [0.4]]
                          ).astype(np.float32)
        out.update({f"{i}/{k}": v for k, v in b.items()})
    return out


def _pinned(job: str, d: Path) -> subprocess.Popen:
    """Start tests/_pinned_parent.py's `job` on <d>, on one intra-op thread
    and a fixed hash seed (its module doc)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **PINNED_ENV}
    log = open(d / f"pinned_{job}.log", "w")
    return subprocess.Popen([sys.executable, str(PINNED), job, str(d)], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


def _wait(proc: subprocess.Popen, job: str, d: Path) -> None:
    try:
        proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if proc.returncode:
        raise AssertionError(f"pinned {job}: exit code {proc.returncode}\n"
                             + (d / f"pinned_{job}.log").read_text()[-3000:])


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every run starts from the reference's initial state of its arch,
    saved as step 0 of ckpt_<arch> (the ranks' trainers resume from it) and
    of single_<arch> (the one-process trainer's). That state, the
    reference's steps and the one-process trainer are made in processes of
    their own, on one intra-op thread as the ranks run and with a fixed
    hash seed (tests/_pinned_parent.py), so that every run of the
    comparison, on any machine, compares the same numbers."""
    d = tmp_path_factory.mktemp("two")
    batches = _vlm_batches()
    np.savez(d / "vlm_batches.npz", **batches)
    _wait(_pinned("init", d), "init", d)
    pinned = _pinned("steps", d)
    try:
        ranks = _spawn("train", 2, d)
    finally:
        _wait(pinned, "steps", d)
    z = np.load(d / "pinned.npz")
    ref = {name: unpack(z, f"ref/{name}") for name in (*TRAIN_ARCHS, "mask")}
    single = {arch: unpack(z, f"single/{arch}") for arch in TRAIN_ARCHS}
    return {"ranks": ranks, "batches": batches, "dir": d, "ref": ref, "single": single}


def _init(two, arch: str) -> dict:
    cfg, _, _, _ = train_setup(arch)
    return ckpt.restore(str(two["dir"] / f"single_{arch}" / "step_00000000"),
                        step.abstract_state(cfg), device="cpu")


NOISE = ("['layers']['attn']['bk']",)     # gradients at AdamW's eps (module doc)


def _close(got: dict, want: dict, prefix: str, gmin: dict | None = None):
    """Losses within 1e-6 relative; parameters but NOISE within 1e-6 of
    their largest magnitude; with `gmin` (the reference's smallest
    |gradient| per element over the steps), only where it stayed above
    EPS_REGIME, and within the two steps' 2 lr elsewhere (module doc)."""
    losses = got[f"{prefix}/loss"]
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-6, atol=0)
    scale = max(np.abs(v).max() for v in want["params"].values())
    for k, v in want["params"].items():
        if k not in NOISE:
            d = np.abs(got[f"{prefix}/{k}"] - v)
            sure = np.ones(v.shape, bool) if gmin is None else gmin[k] > EPS_REGIME
            assert d[sure].max(initial=0) <= 1e-6 * scale, (prefix, k)
            assert d.max() <= 2 * LR, (prefix, k)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_two_data_parallel_trainer_steps_equal_one_process(two, arch):
    """The one-process `trainer.run` (in the pinned process, fixture `two`),
    held where the reference's gradient stayed above EPS_REGIME."""
    for r in two["ranks"]:
        _close(r, two["single"][arch], arch, two["ref"][arch]["gmin"])


def _close_to_reference(got: dict, ref: dict, prefix: str):
    """Losses within 1e-6 relative. Parameters within 1e-6 of their largest
    magnitude wherever the reference's gradient stayed above EPS_REGIME
    in every step, and within the two steps' 2 lr elsewhere (module doc)."""
    np.testing.assert_allclose(got[f"{prefix}/loss"], ref["loss"], rtol=1e-6, atol=0)
    scale = max(np.abs(v).max() for v in ref["params"].values())
    n_sure = n = 0
    for k, v in ref["params"].items():
        d = np.abs(got[f"{prefix}/{k}"] - v)
        sure = ref["gmin"][k] > EPS_REGIME
        assert d[sure].max(initial=0) <= 1e-6 * scale, (prefix, k)
        assert d.max() <= 2 * LR, (prefix, k)
        n_sure, n = n_sure + int(sure.sum()), n + sure.size
    assert n_sure >= 0.95 * n, (prefix, n_sure, n)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_two_data_parallel_trainer_steps_equal_the_reference(two, arch):
    for r in two["ranks"]:
        _close_to_reference(r, two["ref"][arch], arch)


def test_data_parallel_loss_mask_counts_unequal_tokens(two):
    cfg, shape, oc, _ = train_setup("qwen2-vl-2b")
    z = two["batches"]
    mask = z["0/loss_mask"].reshape(2, 2, 1, -1)        # (accum, rank, row, S)
    assert mask[:, 0].sum() != mask[:, 1].sum()
    state = _init(two, "qwen2-vl-2b")
    train_step = step.make_train_step(cfg, shape, oc, remat="none")
    losses = []
    for i in range(2):
        state, m = train_step(state, {k.split("/")[1]: torch.from_numpy(v)
                                      for k, v in z.items() if k.startswith(f"{i}/")})
        losses.append(float(m["loss"]))
    want = {"loss": np.array(losses), "params": flat(state["params"])}
    for r in two["ranks"]:
        _close(r, want, "mask")


def test_data_parallel_loss_mask_steps_equal_the_reference(two):
    for r in two["ranks"]:
        _close_to_reference(r, two["ref"]["mask"], "mask")


def test_data_parallel_gradients_equal_one_process(two):
    """The vlm step's gradients on the unequal-mask batch, reduced over the
    two ranks, against one process's, at every leaf."""
    cfg, shape, _, _ = train_setup("qwen2-vl-2b")
    params = _init(two, "qwen2-vl-2b")["params"]
    batch = {k.split("/")[1]: torch.from_numpy(v) for k, v in two["batches"].items()
             if k.startswith("0/")}
    _, _, grads = step.make_grad_fn(cfg, shape, remat="none")(params, batch)
    want = flat(grads)
    scale = max(np.abs(v).max() for v in want.values())
    for r in two["ranks"]:
        for k, v in want.items():
            assert np.abs(r[f"grad/{k}"] - v).max() <= 1e-6 * scale, k


def test_remat_recompute_on_another_thread_under_data_parallel_moe(two):
    """granite-moe's remat="full" gradients on 2 data ranks, with the
    backward, and so each layer's recompute, on a thread where the
    forward's mesh and reduction group are not set (as on a CUDA
    device thread): equal to one process's remat="none" gradients."""
    cfg, shape, _, kw = train_setup(MOE_ARCH)
    params = _init(two, MOE_ARCH)["params"]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape, 0,
                                                            seed=kw["data_seed"]).items()}
    loss, _, grads = step.make_grad_fn(cfg, shape, remat="none")(params, batch)
    want = flat(grads)
    scale = max(np.abs(v).max() for v in want.values())
    for r in two["ranks"]:
        np.testing.assert_allclose(r["remat/loss"], loss.numpy(), rtol=1e-6)
        for k, v in want.items():
            assert np.abs(r[f"remat/{k}"] - v).max() <= 1e-6 * scale, k


def test_launcher_multi_pod_raises_its_world_size_error(two):
    for r in two["ranks"]:
        assert str(r["multi_pod"]) == ("the production mesh {'pod': 2, 'data': 16, "
                                       "'model': 16} needs 512 ranks; this world has 2")
