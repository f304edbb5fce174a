"""The port's training and optimization ladder against the JAX package's,
on the CPU.

`repro_torch.core.mlp` (training, L0), `quantize.predict_l1..l3` and
`ladder.run_ladder`, and the `mnist-fpga` config, held to
`repro.core.{mlp,quantize,ladder}` and `repro.configs.mnist_fpga` on the
same inputs. Tolerances, stated per test: one SGD step within rtol 1e-5
/ atol 1e-6 (fp32, summation order only); one epoch of 40 steps within
atol 1e-5; L3 bit for bit; L0-L2 equal except on images whose hidden
accumulator or top-two output margin lies within 1e-4 of a tie.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import mnist_fpga as jmnist_fpga
from repro.core import dataset as jdataset
from repro.core import mlp as jmlp
from repro.core import quantize as jquantize
from repro_torch import configs
from repro_torch.configs import mnist_fpga
from repro_torch.core import dataset, mlp, quantize
from repro_torch.core.ladder import run_ladder

ROOT = Path(__file__).resolve().parent.parent
TIE_EPS = 1e-4          # a hidden accumulator or class margin this close to a tie


def _np(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_trained():
    """A JAX-trained 784-64-10 net, its test images and labels."""
    xtr, ytr, xte, yte = jdataset.train_test_split(400, 300, seed=3)
    cfg = jmlp.MLPConfig(n_hidden=64, epochs=8, lr=2.0, seed=7)
    return jmlp.train(cfg, xtr, ytr), xte, yte


def test_mnist_fpga_config_equals_the_reference():
    # every field of the reference; the port's `norm_plus_one` (gemma's
    # norm scale, which the reference decides by name) is off
    ref = dataclasses.asdict(jmnist_fpga.CONFIG)
    assert {k: getattr(mnist_fpga.CONFIG, k) for k in ref} == ref
    assert mnist_fpga.CONFIG.norm_plus_one is False
    assert mnist_fpga.CONFIG.family == "mlp"
    # the reference imports it but keeps it out of the LM registry
    for get_config in (configs.get_config, jconfigs.get_config):
        with pytest.raises(KeyError):
            get_config("mnist-fpga")


def test_datasets_are_the_same_images():
    got = dataset.train_test_split(50, 20, seed=4)
    want = jdataset.train_test_split(50, 20, seed=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_one_sgd_step_equals_the_reference():
    """From JAX's initial weights, one SGD step in the port equals JAX's
    within rtol 1e-5 / atol 1e-6 (fp32 products in another order)."""
    cfg = jmlp.MLPConfig(n_in=64, n_hidden=(32, 16), n_out=10, seed=3)
    init = _np(jmlp.init_params(cfg))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(10, 64)).astype(np.uint8)
    y = rng.integers(0, 10, size=10)
    want = _np(jmlp._sgd_batch(
        {k: jnp.asarray(v) for k, v in init.items()},
        jmlp.scale_inputs(jnp.asarray(x)), jnp.asarray(y), cfg.lr))
    got = mlp._sgd_batch(quantize.params_from_numpy(init),
                         mlp.scale_inputs(torch.from_numpy(x)), torch.from_numpy(y), cfg.lr)
    assert sorted(got) == sorted(want) == ["w1", "w2", "w3"]
    for k in want:
        assert not np.array_equal(want[k], init[k])       # the step moved it
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-6)


def test_one_epoch_walks_the_reference_trajectory(monkeypatch):
    """`train` from JAX's initial weights, one epoch of 40 batches of 10 in
    the reference's batch order, on a 784-64-10 net: within atol 1e-5
    (fp32 summation order; 6e-8 measured)."""
    xtr, ytr, _, _ = jdataset.train_test_split(405, 10, seed=1)   # tail of 5 dropped
    cfg = jmlp.MLPConfig(n_hidden=64, epochs=1, seed=11)
    want = jmlp.train(cfg, xtr, ytr)
    init = quantize.params_from_numpy(_np(jmlp.init_params(cfg)))
    monkeypatch.setattr(mlp, "init_params", lambda c, device=None: dict(init))
    got = mlp.train(mlp.MLPConfig(n_hidden=64, epochs=1, seed=11), xtr, ytr, device="cpu")
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


def test_init_params_is_seeded_and_device_independent():
    cfg = mlp.MLPConfig(n_in=40, n_hidden=24, n_out=10, seed=5)
    a, b = mlp.init_params(cfg, "cpu"), mlp.init_params(cfg, "cpu")
    assert [tuple(v.shape) for v in a.values()] == [(40, 24), (24, 10)]
    for k in a:
        assert torch.equal(a[k], b[k])
        std = float(a[k].std())
        assert 0.5 < std * a[k].shape[0] ** 0.5 < 1.5          # normal(0, 1/sqrt(fan_in))
    other = mlp.init_params(dataclasses.replace(cfg, seed=6), "cpu")
    assert not torch.equal(a["w1"], other["w1"])


def _near_ties(params, x, stage: str) -> np.ndarray:
    """Images whose float64 hidden accumulators or top-two class margin
    lie within TIE_EPS of a tie, at ladder stage L0, L1 or L2."""
    ws = [np.asarray(w, np.float64) for w in quantize.param_weights(params)]
    if stage == "L2":
        a = (x.astype(np.int64) > quantize.INPUT_THRESHOLD).astype(np.float64)
    else:
        a = x.astype(np.float32) / np.float32(255.0) * np.float32(0.99) + np.float32(0.01)
        a = a.astype(np.float64)
    near = np.zeros(len(x), bool)
    for w in ws[:-1]:
        acc = a @ w
        if stage == "L0":
            a = 1.0 / (1.0 + np.exp(-acc))
        else:
            near |= (np.abs(acc) < TIE_EPS).any(axis=1)
            a = (acc > 0).astype(np.float64)
    out = a @ ws[-1]
    if stage == "L0":
        out = 1.0 / (1.0 + np.exp(-out))
    top2 = np.sort(out, axis=1)[:, -2:]
    return near | (top2[:, 1] - top2[:, 0] < TIE_EPS)


def test_ladder_predictors_equal_the_reference(jax_trained):
    """From the same JAX-trained weights: L3 bit for bit; L0, L1 and L2
    equal except on images within TIE_EPS of a tie (counted)."""
    params, xte, yte = jax_trained
    jx = jnp.asarray(xte)
    got3 = quantize.predict_l3(params, "cpu")(xte)
    assert got3.dtype == torch.int32
    np.testing.assert_array_equal(got3.numpy(), np.asarray(jquantize.predict_l3(params)(jx)))
    stages = {"L0": (mlp.predict_l0, jmlp.predict_l0),
              "L1": (quantize.predict_l1, jquantize.predict_l1),
              "L2": (quantize.predict_l2, jquantize.predict_l2)}
    for stage, (port, ref) in stages.items():
        got = port(params, "cpu")(torch.from_numpy(xte)).numpy()
        want = np.asarray(ref(params)(jx))
        near = _near_ties(params, xte, stage)
        differ = got != want
        assert not (differ & ~near).any(), (stage, np.flatnonzero(differ & ~near))
        assert near.sum() < len(xte) // 10, (stage, int(near.sum()))
    acc = mlp.accuracy(quantize.predict_l3(params, "cpu"), xte, yte)
    assert acc == pytest.approx(jmlp.accuracy(jquantize.predict_l3(params), xte, yte))


def test_step_is_strict_and_argmax_takes_the_first_maximum():
    """Hidden accumulators at exactly 0 step to 0 in L1-L3, and tied class
    scores pick the first maximal index, as in the reference."""
    w1 = np.zeros((8, 3), np.float32)
    w1[:, 0] = 1.0                       # unit 0 > 0 for any nonzero input
    w2 = np.array([[0.0, 2.0, 2.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    params = {"w1": w1, "w2": w2}
    x = np.array([[0] * 8, [255] * 8, [100] * 8], np.uint8)
    for port, ref in ((quantize.predict_l1, jquantize.predict_l1),
                      (quantize.predict_l2, jquantize.predict_l2),
                      (quantize.predict_l3, jquantize.predict_l3)):
        got = port(params, "cpu")(x).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref(params)(jnp.asarray(x))))
    # all-zero input: every hidden unit steps off, all scores tie at 0 -> 0;
    # a bright image turns unit 0 on: classes 1 and 2 tie at 2 -> 1
    np.testing.assert_array_equal(quantize.predict_l2(params, "cpu")(x).numpy(), [0, 1, 0])


def test_run_ladder_keeps_the_reference_band_and_exact_rewrites():
    """The port's own ladder on the CPU (its own initial weights): the
    reference test's band (L0 > 0.85; L1-L3 within 0.10 of L0), and every
    L4/L5 backend equal to `predict_l3`."""
    r = run_ladder(n_train=800, n_test=400, epochs=40, seed=3, n_hidden=256,
                   backends=("torch", "cuda", "fused"), device="cpu")
    a0 = r.acc["L0_baseline"]
    assert a0 > 0.85, r.table()
    for k in ("L1_step_act", "L2_binary_input", "L3_int_weights"):
        assert r.acc[k] > a0 - 0.10, r.table()
    assert r.exact_l4_l5
    assert r.acc["L4_pruned"] == r.acc["L5_multfree"] == r.acc["L5_fused"] \
        == r.acc["L3_int_weights"]
    assert r.stats.mults_addend == 0 and 0.05 < r.stats.zero_fraction < 0.95
    assert "L0_baseline" in r.table() and "0.98" in r.table()


def test_run_ladder_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ladder(n_train=20, n_test=10, epochs=1)


def test_torch_quickstart_example(tmp_path):
    """examples/torch_quickstart.py on the CPU: the ladder's L4/L5 rewrites
    are exact and the Verilog module is written."""
    out = tmp_path / "nn_inference_3x3.v"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu", "--verilog-out", str(out)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert "L4/L5 exact rewrites of L3: True" in proc.stdout
    text = out.read_text()
    assert text.startswith("// ") or "module nn_inference" in text
    assert "endmodule" in text and f"[written to {out}]" in proc.stdout
