"""The port's checkpoints and fault-tolerant trainer on the CPU: the
counterparts of `tests/test_checkpoint.py`, checkpoints crossing between
the two packages, resume from a reference checkpoint in both packages,
and the counterpart of `tests/test_system.py`'s train-then-serve round
trip.

A checkpoint names its leaves by `jax.tree_util.keystr` of their paths in
both packages, so one written by either restores in the other exactly.
Resumed runs of the two packages agree to 1e-5 in their losses (fp32
summation order); kill and resume within the port is bit-identical.
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.models import base as jbase
from repro.optim import adamw as jadamw
from repro.train import step as jstep_lib
from repro.train import trainer as jtrainer
from repro_torch import configs
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data.pipeline import make_batch
from repro_torch.models import base, convert
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import step as step_lib
from repro_torch.train import trainer

CFG = configs.smoke("llama3.2-3b")
SHAPE = base.ShapeConfig("smoke", seq_len=16, global_batch=4, kind="train")
OC = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them faster
    than eight that contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    return base.tree_init(step_lib.abstract_state(CFG), torch.Generator().manual_seed(seed),
                          "cpu")


def _assert_trees_equal(a, b):
    pa, pb = list(base.tree_items(a)), list(base.tree_items(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), base.keystr(p)


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    path = ckpt_lib.save(str(tmp_path), 7, state, metadata={"loss": 1.5})
    assert os.path.basename(path) == "step_00000007"
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["step"] == 7 and meta["metadata"] == {"loss": 1.5}
    assert meta["keys"][0] == "['opt']['m']['embed']['tok']"
    assert meta["keys"] == [base.keystr(p) for p, _ in base.tree_items(state)]
    restored = ckpt_lib.restore(path, step_lib.abstract_state(CFG), device="cpu")
    _assert_trees_equal(state, restored)
    assert restored["opt"]["step"].dtype == torch.int32
    # a tensor tree serves as the abstract tree too
    _assert_trees_equal(state, ckpt_lib.restore(path, state, device="cpu"))


def test_restore_checks_leaves_and_casts(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.int32)}}
    path = ckpt_lib.save(str(tmp_path), 1, state)
    cast = ckpt_lib.restore(path, {"a": base.ParamInfo((2, 3), torch.float64),
                                   "b": {"c": base.ParamInfo((4,), torch.int64)}},
                            device="cpu")
    assert cast["a"].dtype == torch.float64 and cast["b"]["c"].dtype == torch.int64
    assert torch.equal(cast["a"], state["a"].double())
    with pytest.raises(ValueError, match="shape"):
        ckpt_lib.restore(path, {"a": base.ParamInfo((3, 2)), "b": state["b"]}, device="cpu")
    with pytest.raises(KeyError, match=r"\['d'\]"):
        ckpt_lib.restore(path, {**state, "d": base.ParamInfo((1,))}, device="cpu")


def test_restore_wants_the_card(tmp_path, monkeypatch):
    path = ckpt_lib.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt_lib.restore(path, {"a": base.ParamInfo((2,))})


def test_atomicity_no_partial_dirs(tmp_path):
    ckpt_lib.save(str(tmp_path), 1, _state())
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))
    assert ckpt_lib.latest_step(str(tmp_path)) == 1
    assert ckpt_lib.latest_step(str(tmp_path / "none")) is None


def test_manager_keeps_last_n(tmp_path):
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == \
        ["step_00000003", "step_00000004"]
    s, restored = mgr.restore_latest(step_lib.abstract_state(CFG), device="cpu")
    assert s == 4
    _assert_trees_equal(state, restored)


def test_kill_resume_bit_identical(tmp_path):
    """Uninterrupted run == (run killed at step 6 -> resumed) run."""
    tc = trainer.TrainerConfig(total_steps=10, ckpt_every=4, ckpt_dir=str(tmp_path / "a"),
                               seed=3, data_seed=11)
    state_a, hist_a = trainer.run(CFG, SHAPE, OC, tc, device="cpu")
    tc_b = trainer.TrainerConfig(total_steps=10, ckpt_every=4, ckpt_dir=str(tmp_path / "b"),
                                 seed=3, data_seed=11, fail_at_step=6)
    with pytest.raises(trainer.InjectedFailure):
        trainer.run(CFG, SHAPE, OC, tc_b, device="cpu")
    meta = json.load(open(tmp_path / "b" / "step_00000006" / "meta.json"))
    assert meta["metadata"]["tag"] == "emergency"
    tc_b.fail_at_step = -1
    state_b, hist_b = trainer.run(CFG, SHAPE, OC, tc_b, resume=True, device="cpu")
    assert hist_b["steps"] == [6, 7, 8, 9] and hist_b["loss"] == hist_a["loss"][6:]
    _assert_trees_equal(state_a, state_b)
    assert sorted(hist_a) == ["failures", "grad_norm", "loss", "step_s", "steps", "stragglers"]


def test_loss_decreases_over_training(tmp_path):
    tc = trainer.TrainerConfig(total_steps=30, ckpt_every=100, ckpt_dir=str(tmp_path / "c"),
                               seed=0)
    _, hist = trainer.run(CFG, SHAPE, OC, tc, device="cpu")
    assert np.mean(hist["loss"][-5:]) < np.mean(hist["loss"][:5])
    assert all(np.isfinite(hist["grad_norm"])) and len(hist["step_s"]) == 30


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """One written by `repro.checkpoint.ckpt.save` restores equal to
    `from_jax_params` of the same state."""
    jcfg = jconfigs.smoke("llama3.2-3b")
    jstate = jbase.tree_init(jstep_lib.abstract_state(jcfg), jax.random.PRNGKey(4))
    path = jckpt.save(str(tmp_path), 3, jstate)
    got = ckpt_lib.restore(path, step_lib.abstract_state(CFG), device="cpu")
    _assert_trees_equal(got, convert.from_jax_params(jax.tree.map(np.asarray, jstate),
                                                     device="cpu"))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _state(seed=5)
    path = ckpt_lib.save(str(tmp_path), 2, state)
    jgot = jckpt.restore(path, jstep_lib.abstract_state(jconfigs.smoke("llama3.2-3b")))
    for (p, a), (jp, b) in zip(base.tree_items(state),
                               jax.tree_util.tree_flatten_with_path(jgot)[0]):
        assert base.keystr(p) == jax.tree_util.keystr(jp)
        assert str(np.asarray(b).dtype) == str(a.dtype).split(".")[-1]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resume_from_one_reference_checkpoint_in_both(tmp_path):
    """`trainer.run(resume=True)` in both packages from the same reference
    checkpoint at step 4 (in fp32): the losses of steps 4-7 agree."""
    jcfg = dataclasses.replace(jconfigs.smoke("llama3.2-3b"), compute_dtype="float32")
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    jshape = jbase.ShapeConfig("smoke", 16, 4, "train")
    joc = jadamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    jtrainer.run(jcfg, jshape, joc, jtrainer.TrainerConfig(
        total_steps=4, ckpt_every=4, ckpt_dir=str(tmp_path / "ref"), seed=3, data_seed=11))
    for d in ("j", "t"):
        shutil.copytree(tmp_path / "ref", tmp_path / d)
    _, jhist = jtrainer.run(jcfg, jshape, joc, jtrainer.TrainerConfig(
        total_steps=8, ckpt_every=4, ckpt_dir=str(tmp_path / "j"), seed=3, data_seed=11),
        resume=True)
    _, hist = trainer.run(cfg, SHAPE, OC, trainer.TrainerConfig(
        total_steps=8, ckpt_every=4, ckpt_dir=str(tmp_path / "t"), seed=3, data_seed=11),
        resume=True, device="cpu")
    assert hist["steps"] == jhist["steps"] == [4, 5, 6, 7]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5, atol=1e-5)


def test_lm_train_then_serve_roundtrip(tmp_path):
    """Train a smoke LM a few steps, checkpoint, restore, serve: the engine
    produces identical generations from the restored parameters."""
    cfg = configs.smoke("gemma-2b")
    shape = base.ShapeConfig("t", 16, 4, "train")
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    state = base.tree_init(step_lib.abstract_state(cfg), torch.Generator().manual_seed(0),
                           "cpu")
    train_step = step_lib.make_train_step(cfg, shape, oc)
    for s in range(5):
        state, _ = train_step(state, {k: torch.as_tensor(v)
                                      for k, v in make_batch(cfg, shape, s).items()})
    path = ckpt_lib.save(str(tmp_path), 5, state)
    restored = ckpt_lib.restore(path, step_lib.abstract_state(cfg), device="cpu")
    prompts = (np.arange(8, dtype=np.int32).reshape(2, 4) * 3) % cfg.vocab
    sc = ServeConfig(max_len=32, max_new_tokens=6)
    out1 = Engine(cfg, state["params"], sc, device="cpu").generate(prompts)
    out2 = Engine(cfg, restored["params"], sc, device="cpu").generate(prompts)
    np.testing.assert_array_equal(out1, out2)
    assert out1.shape == (2, 6)
