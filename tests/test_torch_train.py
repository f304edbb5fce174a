"""Parity of the port's train step with the JAX package's, on the CPU, and
the port's counterparts of `tests/test_models_smoke.py`'s training tests.

A state made by the JAX package (`tree_init(abstract_state)`) is carried
into the port with `models.convert.from_jax_params`; both packages run
three steps of `make_train_step` on the same `make_batch` batches, in
fp32, for every family and modality (dense, moe, ssm, hybrid, vlm,
audio) with `accum` 1 and 2. Losses and the step-1 gradients agree to
1e-5 (of the loss; of the largest |g|): fp32 summation order. The step-1
gradients of the reference are read from its own train step (its
`adamw.apply_updates` is wrapped to return them beside the metrics).
Parameters after several steps are not compared elementwise: AdamW turns
a near-zero gradient's sign into a full +-lr step.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import base as jbase
from repro.optim import adamw as jadamw
from repro.train import step as jstep_lib
from repro_torch import configs
from repro_torch.data.pipeline import make_batch
from repro_torch.models import api, base, convert
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
FAMILIES = {"dense": "gemma-2b", "moe": "granite-moe-1b-a400m", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-2.7b", "vlm": "qwen2-vl-2b", "audio": "musicgen-medium"}
ARCH_NAMES = sorted(configs.ARCHS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than eight that contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.smoke(arch), compute_dtype="float32"),
            dataclasses.replace(configs.smoke(arch), compute_dtype="float32"))


def _t(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_train_step_matches_jax(kind, accum, monkeypatch):
    jcfg, cfg = _cfgs(FAMILIES[kind])
    jshape = jbase.ShapeConfig("t", 16, 4, "train", accum=accum)
    shape = base.ShapeConfig("t", 16, 4, "train", accum=accum)
    joc, oc = (jadamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20),
               adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    real = jadamw.apply_updates

    def with_grads(params, grads, opt_state, o):
        new_p, new_o, metrics = real(params, grads, opt_state, o)
        return new_p, new_o, {**metrics, "grads": grads}

    monkeypatch.setattr(jadamw, "apply_updates", with_grads)
    jstate = jbase.tree_init(jstep_lib.abstract_state(jcfg), jax.random.PRNGKey(0))
    state = convert.from_jax_params(jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jstep_lib.make_train_step(jcfg, jshape, joc, remat="none"))
    step = step_lib.make_train_step(cfg, shape, oc)        # the port's default, remat "full"
    grad_fn = step_lib.make_grad_fn(cfg, shape)
    for s in range(3):
        b = jpipeline.make_batch(jcfg, jshape, s, seed=5)
        if s == 0:
            loss0, metrics0, grads = grad_fn(state["params"], _t(b))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _t(b))
        assert sorted(m) == sorted(k for k in jm if k != "grads"), s
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL, abs=TOL), s
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=TOL), s
        if s == 0:
            assert float(loss0) == float(m["loss"])
            gmax = max(float(jnp.abs(g).max()) for g in jax.tree.leaves(jm["grads"]))
            for (_, g), (_, jg) in zip(base.tree_items(grads),
                                       jax.tree_util.tree_flatten_with_path(jm["grads"])[0]):
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=TOL * gmax)
    assert int(state["opt"]["step"]) == 3


@pytest.mark.parametrize("kind", ["dense", "moe", "ssm", "hybrid"])
def test_remat_full_equals_none(kind):
    """Recomputing each layer in the backward pass gives the same loss
    and gradients as keeping its activations."""
    _, cfg = _cfgs(FAMILIES[kind])
    shape = base.ShapeConfig("t", 16, 2, "train")
    params = base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(1), "cpu")
    b = _t(make_batch(cfg, shape, 0, seed=2))
    out = {r: step_lib.make_grad_fn(cfg, shape, remat=r)(params, b) for r in ("full", "none")}
    assert float(out["full"][0]) == float(out["none"][0])
    for (_, a), (_, g) in zip(base.tree_items(out["full"][2]), base.tree_items(out["none"][2])):
        torch.testing.assert_close(a, g, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        step_lib.make_grad_fn(cfg, shape, remat="some")(params, b)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_grad_step(name):
    """One SGD step on the port's gradients lowers the loss on the same
    batch (the port's counterpart of tests/test_models_smoke.py)."""
    cfg = configs.smoke(name)
    params = base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu")
    b = _t(make_batch(cfg, base.ShapeConfig("smoke", 32, 2, "train"), 0, seed=7))
    grad_fn = step_lib.make_grad_fn(cfg, base.ShapeConfig("smoke", 32, 2, "train"),
                                    remat="none")
    l0, _, grads = grad_fn(params, b)
    gnorm = float(adamw.global_norm(grads))
    assert np.isfinite(float(l0)) and np.isfinite(gnorm) and gnorm > 0, name
    stepped = base.tree_unflatten(
        [p for p, _ in base.tree_items(params)],
        [p - 0.5 * g for (_, p), (_, g) in zip(base.tree_items(params), base.tree_items(grads))])
    assert float(api.loss_fn(cfg, stepped, b)[0]) < float(l0), name


def test_all_archs_present():
    assert len(ARCH_NAMES) == 10, ARCH_NAMES
    assert ARCH_NAMES == sorted(jconfigs.ARCHS)


def test_cell_grid():
    """40 declared cells; long_500k runs only for ssm/hybrid (32 cells)."""
    cells = configs.all_cells()
    assert len(cells) == 10 * 3 + 2, len(cells)
    assert [(c.name, s.name) for c, s in cells] == [(c.name, s.name)
                                                   for c, s in jconfigs.all_cells()]
    skipped = [c.name for c in configs.ARCHS.values()
               if not base.supports_shape(c, base.SHAPES["long_500k"])]
    assert len(skipped) == 8
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-1b-a400m", "zamba2-2.7b"])
def test_abstract_state_matches_jax(arch):
    """The same leaves, by the reference's `keystr` names, shapes and
    dtypes; `tree_sds` gives them as storage-free `meta` tensors."""
    tree = step_lib.abstract_state(configs.smoke(arch))
    jtree = jstep_lib.abstract_state(jconfigs.smoke(arch))
    sds = base.tree_sds(tree)
    got = [(base.keystr(p), tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
           for p, t in base.tree_items(sds)]
    want = [(jax.tree_util.keystr(p), tuple(i.shape), str(np.dtype(i.dtype)), "meta")
            for p, i in jax.tree_util.tree_flatten_with_path(jtree, is_leaf=jbase.is_info)[0]]
    assert got == want
    assert all(base.is_info(i) for _, i in base.tree_items(tree))
    assert not base.is_info(next(base.tree_items(sds))[1])


def test_trainer_wants_the_card(monkeypatch):
    from repro_torch.train import trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.run(configs.smoke("llama3.2-3b"), base.ShapeConfig("s", 8, 2, "train"),
                    adamw.OptConfig(), trainer.TrainerConfig(total_steps=1))


def test_launcher_trains_the_smoke_config(capsys, tmp_path):
    """`python -m repro_torch.launch.train --arch gemma-2b --smoke`: the
    reference's summary line, trained under a one-rank host mesh;
    --resume continues from its checkpoint (restored onto the mesh, then
    gathered whole); --multi-pod raises its world-size error, as the
    reference fails on one device."""
    from repro_torch.launch import train
    args = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    hist = train.main(args + ["--steps", "26"])
    text = capsys.readouterr().out
    assert text.startswith("steps=26 loss ") and "stragglers=" in text
    assert os.listdir(tmp_path) == ["step_00000025"]
    hist = train.main(args + ["--steps", "27", "--resume"])
    assert hist["steps"] == [25, 26]
    with pytest.raises(RuntimeError, match="needs 512 ranks; this world has 1"):
        train.main(args + ["--multi-pod"])


def test_torch_train_lm_example(tmp_path):
    """examples/torch_train_lm.py on the CPU for 2 steps: the 121M model
    trains and checkpoints nothing yet (its first checkpoint is at 50)."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm.py"), "--device", "cpu",
         "--steps", "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "model: repro-120m, 125.8M params, 4x128 tokens/step" in proc.stdout
    assert "trained 2 steps" in proc.stdout and "not compared" in proc.stdout
