"""Parity of the port's W8A8 matmul (`repro_torch.kernels.quant_matmul`)
and of its int8 checkpoint tools (`repro_torch.quantized.apply`) with the
JAX package's, on the CPU.

The same seeded numpy inputs go to both sides; the JAX op runs its
Pallas kernel in interpret mode. The int32 core is exact and the fp32
epilogue runs in the same order, so `quant_matmul` is compared exactly;
quantization rounds half to even on both sides and is compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.quant_matmul import ops as jops
from repro.models import api as japi
from repro.models import base as jbase
from repro.quantized import apply as japply
from repro_torch import configs
from repro_torch.kernels.quant_matmul import ops, ref
from repro_torch.models import api, convert
from repro_torch.quantized import apply


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sw = rng.uniform(0.001, 0.1, size=(n,)).astype(np.float32)
    return xq, wq, np.float32(0.013), sw


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (3, 100, 50), (8, 256, 128),
                                   (5, 37, 131), (70, 130, 9)])
def test_quant_matmul_exact_vs_pallas(m, k, n):
    xq, wq, sx, sw = _operands(m, k, n, m * 7 + k + n)
    got = ops.quant_matmul(torch.from_numpy(xq), torch.from_numpy(wq), float(sx),
                           torch.from_numpy(sw))
    want = jops.quant_matmul(jnp.asarray(xq), jnp.asarray(wq), sx, jnp.asarray(sw))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = ref.int_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    np.testing.assert_array_equal(acc.numpy(), xq.astype(np.int64) @ wq.astype(np.int64))


@pytest.mark.parametrize("k,n", [(2560, 40), (100, 50), (37, 131), (1, 3), (16, 1), (0, 5)])
def test_qmm_weights_keep_shape_and_values(k, n):
    """The K-major copy the kernel reads keeps the public (K, N) shape and
    every value, with K contiguous per column and the column stride a
    multiple of 16 bytes (at least 16)."""
    _, wq, _, _ = _operands(2, k, n, k + n)
    w = torch.from_numpy(wq)
    laid = ops.qmm_weights(w)
    assert laid.shape == (k, n) and laid.dtype == torch.int8
    assert laid.stride(0) == 1 and laid.stride(1) % 16 == 0 and laid.stride(1) >= max(k, 16)
    assert torch.equal(laid, w)
    with pytest.raises(TypeError):
        ops.qmm_weights(w.int())


@pytest.mark.parametrize("m,k,n", [(4, 2560, 40), (3, 100, 50), (5, 37, 131), (70, 130, 9)])
def test_quant_matmul_kmajor_layout_matches_pallas(m, k, n):
    """w_q in the `qmm_weights` layout gives the same result as row-major
    w_q, and both equal the Pallas kernel in interpret mode, K ragged (not
    a multiple of 16) included."""
    xq, wq, sx, sw = _operands(m, k, n, m + 3 * k + n)
    want = np.asarray(jops.quant_matmul(jnp.asarray(xq), jnp.asarray(wq), sx, jnp.asarray(sw)))
    x, w, s = torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(sw)
    np.testing.assert_array_equal(ops.quant_matmul(x, ops.qmm_weights(w), float(sx), s).numpy(),
                                  want)
    np.testing.assert_array_equal(ops.quant_matmul(x, w, float(sx), s).numpy(), want)
    y = ops.qlinear(torch.from_numpy(xq.astype(np.float32)), ops.qmm_weights(w), s)
    assert torch.equal(y, ops.qlinear(torch.from_numpy(xq.astype(np.float32)), w, s))


def test_quant_matmul_takes_a_scale_tensor_and_counts_no_cpu_launch():
    xq, wq, sx, sw = (torch.from_numpy(np.asarray(v)) for v in _operands(4, 96, 33, 1))
    ops.reset_launches()
    got = ops.quant_matmul(xq, wq, sx, sw)
    assert torch.equal(got, ref.quant_matmul_ref(xq, wq, sx, sw))
    assert torch.equal(got, ops.quant_matmul(xq, wq, float(sx), sw))
    assert ops.quant_matmul.launches == 0 and ops.quant_matmul.narrow_launches == 0
    with pytest.raises(ValueError):
        ops.quant_matmul(xq, wq[:-1], sx, sw)
    with pytest.raises(ValueError):
        ops.quant_matmul(xq, wq, torch.ones(2), sw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_and_weight_equal_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 256)).astype(np.float32) * 3
    w = rng.normal(size=(256, 64)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = ops.quantize_act(tx)
    qj, sj = jops.quantize_act(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert s.dtype == torch.float32 and float(s) == float(sj)
    q, s = ops.quantize_weight(torch.from_numpy(w))
    qj, sj = jops.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlinear_close_to_float_and_to_jax(dtype):
    """W8A8 stays within 2 % of the fp matmul (the JAX test's bound), and
    equals the JAX op up to the final cast to x's dtype."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    wq, sw = ops.quantize_weight(torch.from_numpy(w))
    y = ops.qlinear(tx, wq, sw)
    assert y.dtype == tx.dtype
    want = tx.float().numpy() @ w
    err = np.linalg.norm(y.float().numpy() - want) / np.linalg.norm(want)
    assert err < 0.02, err
    yj = jops.qlinear(jnp.asarray(x, dtype), jnp.asarray(wq.numpy()), jnp.asarray(sw.numpy()))
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(yj, np.float32))


@pytest.fixture(scope="module")
def smoke_params():
    jcfg = jconfigs.smoke("mamba2-2.7b")
    pj = jbase.tree_init(japi.abstract_params(jcfg), jax.random.PRNGKey(2))
    pn = jax.tree.map(np.asarray, pj)
    return jcfg, pn, convert.from_jax_params(pn, device="cpu")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


def _assert_trees_equal(port, jax_tree):
    a, b = _flat(port), _flat(jax.tree.map(np.asarray, jax_tree))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("min_size", [0, 1 << 14])
def test_quantize_tree_and_dequantize_equal_jax(smoke_params, min_size):
    _, pn, pt = smoke_params
    qt, stats = apply.quantize_tree(pt, min_size=min_size)
    qj, stats_j = japply.quantize_tree(pn, min_size=min_size)
    assert stats == stats_j
    _assert_trees_equal(qt, qj)
    _assert_trees_equal(apply.dequantize_tree(qt), japply.dequantize_tree(qj))


def test_quantize_params_for_serving_equal_jax(smoke_params):
    jcfg, pn, pt = smoke_params
    cfg = configs.smoke("mamba2-2.7b")
    qt = apply.quantize_params_for_serving(cfg, pt, min_size=0)
    qj = japply.quantize_params_for_serving(jcfg, pn, min_size=0)
    _assert_trees_equal(qt, qj)
    assert qt["layers"]["mixer"]["in_proj"]["s"].shape == (2, 2 * 128 + 2 * 16 + 8)
    assert set(qt["embed"]["tok"]) == {"q", "s"}
    assert isinstance(qt["layers"]["mixer"]["conv_w"], torch.Tensor)
    # the abstract tree and the materialized one agree on every shape
    assert api.abstract_params(cfg)["layers"]["mixer"]["in_proj"].shape == \
        tuple(pt["layers"]["mixer"]["in_proj"].shape)


def test_prune_stats_equal_jax(smoke_params):
    _, pn, pt = smoke_params
    for thr in (0.0, 0.05):
        assert apply.prune_stats(pt, thr) == japply.prune_stats(pn, thr)
    pt = {**pt, "embed": {**pt["embed"], "head": pt["embed"]["head"].clone()}}
    pt["embed"]["head"][:, :7] = 0
    pn = {**pn, "embed": {**pn["embed"], "head": pt["embed"]["head"].numpy()}}
    st = apply.prune_stats(pt)
    assert st == japply.prune_stats(pn) and st["dead_channels"] == 7
