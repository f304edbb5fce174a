"""Parity of the port's fused two-layer op (`repro_torch.kernels.fused_mlp`)
with the JAX package's, on the CPU.

The port's wrapper takes its plain PyTorch version for CPU tensors; the
JAX side runs its Pallas kernel in the package's default interpret mode
and its jnp reference. The same seeded numpy inputs go to both, and
every comparison is exact: the path is integer.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.fused_mlp import ops as jops
from repro.kernels.fused_mlp import ref as jref
from repro_torch.kernels.fused_mlp import ops, ref

from _netgen_helpers import images


def _weights(seed, k, h, o, dtype=np.int32, lo=-9, hi=9):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi + 1, size=(k, h)).astype(dtype),
            rng.integers(lo, hi + 1, size=(h, o)).astype(dtype))


def _both(x, w1, w2, threshold, **kw):
    """(port, Pallas interpret, jnp reference) predictions."""
    got = ops.fused_mlp_predict(torch.from_numpy(x), torch.from_numpy(w1),
                                torch.from_numpy(w2), threshold=threshold, **kw)
    pallas = np.asarray(jops.fused_mlp_predict(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), threshold=threshold))
    oracle = np.asarray(jref.fused_mlp_predict_ref(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), threshold=threshold))
    assert got.dtype == torch.int32 and got.shape == (x.shape[0],)
    return got.numpy(), pallas, oracle


@pytest.mark.parametrize("threshold", [0, 128, 254])
def test_paper_shape_matches_pallas(threshold):
    """The 784-500-10 net at a small batch, at the threshold's edges."""
    w1, w2 = _weights(threshold, 784, 500, 10)
    x = images(threshold, 5, 784)
    got, pallas, oracle = _both(x, w1, w2, threshold)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("k,h,o,b", [(45, 21, 7, 11), (64, 32, 3, 1), (33, 70, 12, 9)])
def test_ragged_shapes_and_int8_weights(k, h, o, b):
    w1, w2 = _weights(k + h, k, h, o, dtype=np.int8)
    x = images(k, b, k)
    got, pallas, oracle = _both(x, w1, w2, 128, bm=4)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


def test_all_scores_negative():
    """Every class score negative: the first maximum still wins."""
    w1, _ = _weights(3, 40, 16, 6)
    w2 = -np.random.default_rng(4).integers(1, 6, size=(16, 6)).astype(np.int32)
    x = images(3, 9, 40)
    x[:, :8] = 255
    got, pallas, oracle = _both(x, w1, w2, 128)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
    hidden = ((x.astype(np.int64) > 128) @ w1) > 0
    scores = hidden @ w2.astype(np.int64)
    assert hidden.any(axis=1).all() and (scores < 0).all()
    np.testing.assert_array_equal(got, np.argmax(scores, axis=1))


def test_ties_go_to_the_lower_class():
    w1 = np.ones((8, 4), np.int32)
    w2 = np.array([[1, 3, 3, 2]] * 4, np.int32)
    x = np.full((3, 8), 200, np.uint8)
    got, pallas, _ = _both(x, w1, w2, 128)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, [1, 1, 1])


def test_plain_version_is_the_wrappers_cpu_path():
    w1, w2 = _weights(5, 50, 20, 4)
    x = torch.from_numpy(images(5, 6, 50))
    ops.reset_launches()
    got = ops.fused_mlp_predict(x, torch.from_numpy(w1), torch.from_numpy(w2),
                                threshold=100)
    plain = ref.fused_mlp_predict(x, torch.from_numpy(w1), torch.from_numpy(w2),
                                  threshold=100)
    assert torch.equal(got, plain)
    assert ops.fused_mlp_predict.launches == 0


def test_rejects_what_the_kernel_cannot_take():
    w1, w2 = (torch.from_numpy(w) for w in _weights(6, 40, 16, 6))
    x = torch.from_numpy(images(6, 4, 40))
    with pytest.raises(ValueError):              # unsupported rows per block
        ops.fused_mlp_predict(x, w1, w2, threshold=128, bm=3)
    with pytest.raises(ValueError):              # inputs and w1 disagree
        ops.fused_mlp_predict(x[:, :30], w1, w2, threshold=128)
    with pytest.raises(ValueError):              # images must be uint8
        ops.fused_mlp_predict(x.int(), w1, w2, threshold=128)
    with pytest.raises(TypeError):
        ops.fused_mlp_predict(x, w1.long(), w2, threshold=128)
    with pytest.raises(ValueError):              # activations beyond shared memory
        ops.check_fused(2_000_000, 500, 10, bm=32)
    assert ops.check_fused(784, 500, 10) == ops.FUSED_BM
    assert ops.fused_smem_bytes(784, 500, 10, 2) == 4 * 2 * (25 + 16 + 10)
