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


def test_tensor_core_route_states_its_shared_memory():
    """The int8 route's block: a 4-slot ring of 16 + 64 rows of 272 bytes,
    16 rows of the block's hidden units (ceil(H / 8) rounded up to 64) and
    O columns of w2 over them as bytes, and 16 x O partial scores; refused
    on every device past the limit, whatever bm."""
    assert ops.fused_mma_smem_bytes(500, 10) == 4 * 80 * 272 + 26 * 64 + 4 * 16 * 10
    assert ops.fused_mma_smem_bytes(1100, 12) == 4 * 80 * 272 + 28 * 192 + 4 * 16 * 12
    assert ops.check_fused(784, 500, 10, mma=True) == ops.FUSED_BM
    with pytest.raises(ValueError):
        ops.check_fused(784, 100_000, 10, mma=True)
    with pytest.raises(ValueError):              # the int8 route on the CPU refuses too
        ops.fused_mlp_predict(torch.zeros((2, 8), dtype=torch.uint8),
                              torch.zeros((8, 100_000), dtype=torch.int8),
                              torch.zeros((100_000, 3), dtype=torch.int8), threshold=1)
    assert ops.check_fused(784, 100_000, 10, bm=1) == 1     # the scalar route takes it


@pytest.mark.parametrize("wide", [False, True])
def test_compile_fused_holds_int8_weights_when_the_net_fits(wide, monkeypatch):
    """`compile_fused` holds both layers as int8 in the tensor-core layout
    (`mma_weights`) when every weight fits int8, else int32 (one |w| = 200
    is enough); either way its plain route equals JAX's
    `fused_mlp_predict(interpret=True)` and `predict_quantized`."""
    from repro_torch import netgen
    from repro_torch.core import quantize
    from repro_torch.kernels.binary_matvec import ops as bops
    from repro_torch.netgen.backends import cuda
    from repro.core import quantize as jquantize
    w1, w2 = _weights(90, 45, 21, 7)
    if wide:
        w2[3, 2] = 200
    net = quantize.from_numpy([w1, w2])
    seen = []
    real = ops.fused_mlp_predict

    def spy(x, a, b, **kw):
        seen.append((a, b))
        return real(x, a, b, **kw)

    monkeypatch.setattr(ops, "fused_mlp_predict", spy)
    x = images(90, 13, 45)
    got = cuda.compile_fused(netgen.lower(net), device=torch.device("cpu"))(x).numpy()
    (a, b), = seen
    assert {a.dtype, b.dtype} == {torch.int32 if wide else torch.int8}
    if not wide:
        assert bops.in_mma_layout(a) and b.stride(0) == 1
    pallas = np.asarray(jops.fused_mlp_predict(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), threshold=128, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    jnet = jquantize.QuantizedNet(weights=[w1, w2])
    np.testing.assert_array_equal(
        got, np.asarray(jquantize.predict_quantized(jnet)(jnp.asarray(x))))
