"""Parity of the port's bit-plane ops (`repro_torch.kernels.binary_matvec`)
with the JAX package's, on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the JAX side runs its Pallas kernels in the package's default interpret
mode and its jnp references. The same seeded numpy inputs go to both,
and every comparison is exact: the paths are integer.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import netgen as jnetgen
from repro.kernels.binary_matvec import ops as jops
from repro.kernels.binary_matvec import ref as jref
from repro.netgen.plan import lower_circuit as jlower_circuit
from repro.netgen.plan import stack_plans as jstack_plans
from repro.core import quantize as jquantize
from repro_torch.kernels.binary_matvec import ops, ref

from _netgen_helpers import images, random_net


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy words (uint32) or images (uint8) as the port's tensors."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Packers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,words,thr", [(50, 2, 128), (64, 2, 0), (33, 3, 254),
                                         (5, 1, 100)])
def test_binarize_pack_words_equal(n, words, thr):
    x = images(n, 7, n)
    want = np.asarray(jops.binarize_pack(jnp.asarray(x), threshold=thr,
                                         words=words))
    got = ops.binarize_pack(_t(x), threshold=thr, words=words)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n,words", [(40, 2), (96, 3), (7, 1)])
def test_step_pack_words_equal(n, words):
    rng = np.random.default_rng(n)
    acc = rng.integers(-3, 4, size=(9, n)).astype(np.int32)   # zeros included
    want = np.asarray(jops.step_pack(jnp.asarray(acc), words=words))
    got = ops.step_pack(torch.from_numpy(acc), words=words)
    np.testing.assert_array_equal(_u32(got), want)


def test_pack_bool_rejects_overflow():
    with pytest.raises(ValueError):
        ref.pack_bool(torch.ones((2, 40), dtype=torch.bool), 1)


def test_unpack_bits_and_popcount():
    rng = np.random.default_rng(3)
    xp = _words(rng, (6, 4))
    want = np.asarray(jref.unpack_bits_ref(jnp.asarray(xp), 100))
    np.testing.assert_array_equal(ref.unpack_bits(_t(xp), 100).numpy(), want)
    counts = np.array([bin(int(v)).count("1") for v in xp.ravel()]).reshape(xp.shape)
    np.testing.assert_array_equal(ref.popcount(_t(xp)).numpy(), counts)


@pytest.mark.parametrize("b,k", [(3, 70), (2, 64), (1, 784), (4, 5)])
def test_pack_bits_words_equal(b, k):
    """Any nonzero activation is a set bit; K pads up to whole words."""
    x = np.random.default_rng(b * 100 + k).integers(-2, 3, size=(b, k)).astype(np.int8)
    want = np.asarray(jops.pack_bits(jnp.asarray(x)))
    got = ops.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (b, -(-k // 32))
    np.testing.assert_array_equal(_u32(got), want)


# ---------------------------------------------------------------------------
# binary_matmul and binary_matmul_packed
# ---------------------------------------------------------------------------

# The paper's two layers at small batch, and a ragged shape: K and N no
# multiple of 32 (or of the Pallas tiles).
MATMUL_SHAPES = [(1, 784, 500), (4, 500, 10), (3, 200, 77)]


def _bits(rng, b, k) -> np.ndarray:
    return rng.integers(0, 2, size=(b, k)).astype(np.int8)


@pytest.mark.parametrize("wdtype", [np.int32, np.int8])
@pytest.mark.parametrize("b,k,n", MATMUL_SHAPES)
def test_binary_matmul_matches_pallas_and_ref(b, k, n, wdtype):
    rng = np.random.default_rng(b * 1000 + k + n)
    x = _bits(rng, b, k)
    w = rng.integers(-9, 10, size=(k, n)).astype(wdtype)
    pallas = np.asarray(jops.binary_matmul(jnp.asarray(x), jnp.asarray(w)))
    oracle = np.asarray(jref.binary_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    got = ops.binary_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("wdtype", [np.int32, np.int8])
@pytest.mark.parametrize("b,k,n", MATMUL_SHAPES)
def test_binary_matmul_packed_matches_pallas(b, k, n, wdtype):
    """The activations packed by `pack_bits` (K padded to whole words)
    against the Pallas kernel on the same words and zero-padded w."""
    rng = np.random.default_rng(b * 1000 + k + n + 1)
    x = _bits(rng, b, k)
    w = rng.integers(-9, 10, size=(k, n)).astype(wdtype)
    xp = np.asarray(jops.pack_bits(jnp.asarray(x)))
    wp = np.zeros((xp.shape[1] * 32, n), wdtype)
    wp[:k] = w
    pallas = np.asarray(jops.binary_matmul_packed(jnp.asarray(xp), jnp.asarray(wp)))
    got = ops.binary_matmul_packed(ops.pack_bits(torch.from_numpy(x)), torch.from_numpy(wp))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        got.numpy(), (x.astype(np.int64) @ w.astype(np.int64)).astype(np.int32))


def test_binary_matmul_wraps_like_int32():
    """Sums past int32 wrap as the Pallas kernel's int32 accumulator does."""
    rng = np.random.default_rng(9)
    x = np.ones((3, 96), np.int8)
    x[1, ::3] = 0
    w = rng.integers(2 ** 29, 2 ** 31 - 1, size=(96, 5)).astype(np.int32)
    pallas = np.asarray(jops.binary_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = ops.binary_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), pallas)
    xp = np.array(jops.pack_bits(jnp.asarray(x)))
    packed = ops.binary_matmul_packed(_t(xp), torch.from_numpy(w))
    np.testing.assert_array_equal(packed.numpy(), pallas)
    assert (pallas != (x.astype(np.int64) @ w.astype(np.int64))).any()


@pytest.mark.parametrize("b,k,n,lo,hi", [(5, 784, 500, -9, 9), (17, 70, 10, -128, 127),
                                         (3, 200, 77, -128, 127), (33, 500, 10, -128, -128)])
def test_int8_and_int32_weights_give_equal_results(b, k, n, lo, hi):
    """The int8 form of a net's weights (the tensor-core route on the
    card) and its int32 form (the scalar route) give the same int32
    result, at the int8 extremes too, dense and packed; activations are
    any nonzero byte."""
    rng = np.random.default_rng(b + k + n)
    x = torch.from_numpy(rng.integers(-2, 3, size=(b, k)).astype(np.int8))
    w8 = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int8)
    w8[0], w8[-1] = -128, 127
    w8, w32 = torch.from_numpy(w8), torch.from_numpy(w8.astype(np.int32))
    want = (x.numpy() != 0).astype(np.int64) @ w32.numpy().astype(np.int64)
    dense = ops.binary_matmul(x, w8)
    assert dense.dtype == torch.int32
    np.testing.assert_array_equal(dense.numpy(), want)
    np.testing.assert_array_equal(ops.binary_matmul(x, w32).numpy(), want)
    laid = ops.mma_weights(w8)
    assert laid.shape == (k, n) and laid.stride(0) == 1 and laid.stride(1) % 16 == 0
    np.testing.assert_array_equal(ops.binary_matmul(x, laid).numpy(), want)
    xp = ops.pack_bits(x)
    kp = xp.shape[1] * 32
    pad8 = torch.zeros((kp, n), dtype=torch.int8)
    pad8[:k] = w8
    packed8 = ops.binary_matmul_packed(xp, pad8)
    np.testing.assert_array_equal(packed8.numpy(), want)
    np.testing.assert_array_equal(
        ops.binary_matmul_packed(xp, pad8.to(torch.int32)).numpy(), want)


def test_binary_matmul_rejects_bad_operands():
    x = torch.zeros((4, 64), dtype=torch.int8)
    w = torch.zeros((64, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.binary_matmul(x, w[:60])
    with pytest.raises(TypeError):
        ops.binary_matmul(x.int(), w)
    with pytest.raises(TypeError):
        ops.binary_matmul(x, w.long())
    with pytest.raises(ValueError):            # K != 32 x words
        ops.binary_matmul_packed(torch.zeros((4, 2), dtype=torch.int32), w[:60])
    with pytest.raises(TypeError):
        ops.binary_matmul_packed(torch.zeros((4, 2), dtype=torch.int64), w)
    assert ops.check_matmul_blocks(defaults=(ops.DENSE_BM, ops.DENSE_BN)) == \
        (ops.DENSE_BM, ops.DENSE_BN)


# ---------------------------------------------------------------------------
# binary_matmul_planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,kw,n,p", [(5, 3, 10, 1), (17, 13, 45, 4),
                                      (8, 9, 33, 6), (3, 1, 1, 4)])
def test_binary_matmul_planes_matches_pallas_and_ref(b, kw, n, p):
    """KW not a multiple of 8, N not a multiple of 32, P in {1, 4, 6}."""
    rng = np.random.default_rng(b * 1000 + kw * 10 + p)
    xp, pos, neg = _words(rng, (b, kw)), _words(rng, (p, kw, n)), \
        _words(rng, (p, kw, n))
    pallas = np.asarray(jops.binary_matmul_planes(
        jnp.asarray(xp), jnp.asarray(pos), jnp.asarray(neg)))
    oracle = np.asarray(jref.plane_matmul_ref(
        jnp.asarray(xp), jnp.asarray(pos), jnp.asarray(neg)))
    got = ops.binary_matmul_planes(_t(xp), _t(pos), _t(neg))
    plain = ref.plane_matmul(_t(xp), _t(pos), _t(neg))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(plain.numpy(), oracle)


@pytest.mark.parametrize("lead,p,kw,n", [((), 4, 25, 500), ((), 1, 3, 10), ((), 6, 9, 33),
                                         ((3,), 4, 16, 10), ((2,), 2, 8, 1)])
def test_plane_mma_weights_keep_shape_and_values(lead, p, kw, n):
    """The K-major copy keeps the public (..., P, KW, N) shape and every
    word, with KW contiguous per column and columns 32-byte aligned."""
    rng = np.random.default_rng(p * 100 + kw + n)
    planes = _t(_words(rng, (*lead, p, kw, n)))
    laid = ops.plane_mma_weights(planes)
    assert laid.shape == planes.shape and laid.dtype == torch.int32
    assert laid.stride(-2) == 1 and laid.stride(-1) % 8 == 0 and laid.stride(-1) >= kw
    assert torch.equal(laid, planes)
    if lead:
        assert torch.equal(laid[1], planes[1]) and laid[1].stride() == laid[0].stride()
    with pytest.raises(TypeError):
        ops.plane_mma_weights(planes.long())


@pytest.mark.parametrize("b,kw,n,p", [(5, 3, 10, 1), (17, 13, 45, 4), (8, 9, 33, 6),
                                      (40, 25, 70, 4), (3, 1, 1, 8), (11, 17, 9, 2)])
def test_binary_matmul_planes_kmajor_layout_matches_pallas(b, kw, n, p):
    """Planes in the `plane_mma_weights` layout the backend holds give the
    same words as contiguous planes, and both equal the Pallas kernel in
    interpret mode; KW ragged (not a multiple of 8) included."""
    rng = np.random.default_rng(b * 100 + kw * 10 + p + 5)
    xp, pos, neg = _words(rng, (b, kw)), _words(rng, (p, kw, n)), _words(rng, (p, kw, n))
    pallas = np.asarray(jops.binary_matmul_planes(
        jnp.asarray(xp), jnp.asarray(pos), jnp.asarray(neg)))
    flat = ops.binary_matmul_planes(_t(xp), _t(pos), _t(neg))
    laid = ops.binary_matmul_planes(_t(xp), ops.plane_mma_weights(_t(pos)),
                                    ops.plane_mma_weights(_t(neg)))
    np.testing.assert_array_equal(laid.numpy(), pallas)
    np.testing.assert_array_equal(flat.numpy(), pallas)
    assert ops.planes_smem_bytes(32, 4) == 2 * (32 + 8 * 32) * 12 * 4


def test_binary_matmul_planes_wraps_like_int32():
    """24 planes of mostly set words overflow int32 the way the Pallas
    kernel's int32 accumulator does (in the K-major layout)."""
    b, kw, n, p = 4, 40, 9, 24
    rng = np.random.default_rng(12)
    xp = np.full((b, kw), 0xFFFFFFFF, np.uint32)
    pos = np.full((p, kw, n), 0xFFFFFFFF, np.uint32)
    neg = _words(rng, (p, kw, n)) & np.uint32(0x0000FFFF)
    pos[-1, :, ::2] = 0
    pallas = np.asarray(jops.binary_matmul_planes(
        jnp.asarray(xp), jnp.asarray(pos), jnp.asarray(neg)))
    got = ops.binary_matmul_planes(_t(xp), ops.plane_mma_weights(_t(pos)),
                                   ops.plane_mma_weights(_t(neg)))
    np.testing.assert_array_equal(got.numpy(), pallas)
    def popc(a):                    # (P, KW, N) words -> set bits per (P, N)
        return np.unpackbits(a.view(np.uint8).reshape(*a.shape, 4), axis=-1).sum((1, 3))

    exact = ((popc(pos) - popc(neg)).astype(np.int64) << np.arange(p)[:, None]).sum(0)
    assert (exact >= 2 ** 31).any()          # the column sums wrap
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(exact.astype(np.int32), (b, n)))


def test_binary_matmul_planes_rejects_bad_operands():
    x = torch.zeros((4, 3), dtype=torch.int32)
    w = torch.zeros((2, 3, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.binary_matmul_planes(x, w, w[:, :2])
    with pytest.raises(TypeError):
        ops.binary_matmul_planes(x.long(), w, w)
    with pytest.raises(ValueError):
        ops.check_matmul_blocks(bm=3)
    with pytest.raises(ValueError):
        ops.check_matmul_blocks(bn=48)
    assert ops.check_matmul_blocks() == (ops.MATMUL_BM, ops.MATMUL_BN)


# ---------------------------------------------------------------------------
# binary_forward_planes
# ---------------------------------------------------------------------------

def _view(net):
    return jlower_circuit(jnetgen.lower(net)).megakernel_view()


@pytest.mark.parametrize("sizes", [(40, 6), (45, 21, 7), (33, 40, 12, 5)])
def test_binary_forward_planes_single_depths(sizes):
    """Depth 1-3, fan-ins and fan-outs straddling the 32-lane word."""
    net = random_net(len(sizes), sizes, lo=-5, hi=5)
    view = _view(net)
    x = images(len(sizes), 11, sizes[0])
    kw = {"threshold": view.input_threshold, "n_classes": view.n_classes}
    pallas = np.asarray(jops.binary_forward_planes(
        jnp.asarray(x), *[jnp.asarray(a) for a in view.arrays], **kw))
    got = ops.binary_forward_planes(_t(x), *[_t(a) for a in view.arrays], **kw)
    assert got.dtype == torch.int32 and got.shape == (11,)
    np.testing.assert_array_equal(got.numpy(), pallas)
    dense = np.asarray(jquantize.predict_quantized(net)(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), dense)


def test_binary_forward_planes_stacked_padded_widths():
    sizes = ((20, 13, 5), (20, 16, 5), (20, 19, 5))
    nets = [random_net(20 + i, s, lo=-5, hi=5) for i, s in enumerate(sizes)]
    view = jstack_plans([jlower_circuit(jnetgen.lower(n)) for n in nets]
                        ).megakernel_view()
    x = np.stack([images(21 + m, 8, 20) for m in range(3)])
    kw = {"threshold": view.input_threshold, "n_classes": view.n_classes}
    pallas = np.asarray(jops.binary_forward_planes(
        jnp.asarray(x), *[jnp.asarray(a) for a in view.arrays], **kw))
    got = ops.binary_forward_planes(_t(x), *[_t(a) for a in view.arrays], **kw)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_binary_forward_planes_all_scores_negative():
    """Every real class score negative: the first maximum among the real
    classes wins, never a padded one."""
    rng = np.random.default_rng(5)
    w = -rng.integers(1, 6, size=(40, 6)).astype(np.int32)
    net = jquantize.QuantizedNet(weights=[w])
    view = _view(net)
    x = images(5, 9, 40)
    x[:, :8] = 255                                    # some bits set per row
    kw = {"threshold": view.input_threshold, "n_classes": view.n_classes}
    got = ops.binary_forward_planes(_t(x), *[_t(a) for a in view.arrays], **kw)
    pallas = np.asarray(jops.binary_forward_planes(
        jnp.asarray(x), *[jnp.asarray(a) for a in view.arrays], **kw))
    np.testing.assert_array_equal(got.numpy(), pallas)
    scores = (x.astype(np.int64) > 128) @ w
    assert (scores < 0).all()
    np.testing.assert_array_equal(got.numpy(), np.argmax(scores, axis=1))


def test_binary_forward_planes_rejects_bad_layouts():
    net = random_net(9, (40, 21, 7), lo=-5, hi=5)
    arrays = [_t(a) for a in _view(net).arrays]
    x = _t(images(9, 4, 40))
    with pytest.raises(ValueError):           # n_classes beyond the scores
        ops.binary_forward_planes(x, *arrays, threshold=128, n_classes=8)
    with pytest.raises(ValueError):           # hidden N != 32 x next words
        ops.binary_forward_planes(x, arrays[0][..., :20], arrays[1][..., :20],
                                  *arrays[2:], threshold=128, n_classes=7)
    with pytest.raises(ValueError):           # unsupported rows per block
        ops.binary_forward_planes(x, *arrays, threshold=128, n_classes=7, bm=3)
    with pytest.raises(ValueError):           # no layer
        ops.check_forward_planes([])
    with pytest.raises(ValueError):           # activations beyond shared memory
        ops.check_forward_planes([4000], bm=32)


@pytest.mark.parametrize("depth", [17, 40])
def test_binary_forward_planes_takes_any_depth(depth):
    """No depth cap: the layer table lies in device memory, so a net
    deeper than 16 layers is accepted and equals JAX's kernel and the
    plain chain; its table has one 32-byte row per layer."""
    net = random_net(depth, (16,) * depth + (5,), lo=-3, hi=3)
    view = _view(net)
    assert len(view.layer_words) == depth
    assert ops.check_forward_planes(view.layer_words) == ops.FORWARD_BM
    arrays = [_t(a) for a in view.arrays]
    table = ops.ForwardTable(arrays)
    assert table.rows.shape == (depth, 4) and table.rows.dtype == torch.int64
    assert table.key == tuple((a.data_ptr(), tuple(a.shape)) for a in arrays)
    x = images(depth, 9, 16)
    kw = {"threshold": view.input_threshold, "n_classes": view.n_classes}
    got = ops.binary_forward_planes(_t(x), *arrays, table=table, **kw)
    pallas = np.asarray(jops.binary_forward_planes(
        jnp.asarray(x), *[jnp.asarray(a) for a in view.arrays], **kw))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jquantize.predict_quantized(net)(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# binary_forward_planes on planes in the backend's layout
# (`plane_mma_weights`, the tensor-core route's), against JAX
# ---------------------------------------------------------------------------

def _random_planes(rng, lead, p, words, n_classes):
    """Random uint32 plane words for layers of `words` input words each;
    a hidden layer's fan_out is 32 x the next layer's words."""
    arrays = []
    for i, w in enumerate(words):
        n = n_classes if i + 1 == len(words) else 32 * words[i + 1]
        arrays += [_words(rng, (*lead, p, w, n)) for _ in range(2)]
    return arrays


def _forward_both(x, arrays, threshold, n_classes):
    """(port on the `plane_mma_weights` layout, JAX's interpret-mode
    kernel) on the same numpy inputs."""
    kw = {"threshold": threshold, "n_classes": n_classes}
    held = [ops.plane_mma_weights(_t(a)) for a in arrays]
    got = ops.binary_forward_planes(_t(x), *held, **kw)
    pallas = np.asarray(jops.binary_forward_planes(
        jnp.asarray(x), *[jnp.asarray(a) for a in arrays], **kw))
    return got, pallas


@pytest.mark.parametrize("lead,b,p,words,k", [
    ((), 1, 4, (2, 16, 1), 50), ((), 17, 4, (2, 16, 1), 50), ((), 255, 4, (2, 16, 1), 50),
    ((3,), 1, 4, (2, 16, 1), 64), ((3,), 17, 2, (2, 4, 1), 64), ((2,), 255, 3, (2, 1, 1), 40),
    ((), 40, 1, (1, 1, 1), 32), ((), 40, 2, (2, 32, 1), 33), ((), 40, 3, (3, 2, 4, 1), 70),
    ((), 40, 5, (1, 8, 1), 20), ((), 40, 6, (1, 3, 1), 20), ((), 40, 7, (2, 1, 1), 60),
    ((), 40, 8, (1, 2, 1), 31),
])
def test_binary_forward_planes_backend_layout_equals_jax(lead, b, p, words, k):
    """Single and stacked, B ragged against 16- and 32-row tiles, P from 1
    to 8, hidden widths from 32 to 1024 units, random words (their sums
    step about half the units on)."""
    rng = np.random.default_rng(b + p + len(words))
    n_classes = 7
    arrays = _random_planes(rng, lead, p, words, n_classes)
    x = rng.integers(0, 256, size=(*lead, b, k)).astype(np.uint8)
    got, pallas = _forward_both(x, arrays, 128, n_classes)
    assert got.shape == (*lead, b)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("case", ["deep17", "all_negative", "wrap"])
def test_binary_forward_planes_backend_layout_nets(case):
    """A 17-layer width-16 net, a net whose every real score is negative,
    and the net whose hidden accumulator wraps at 2**31 (class 1), each
    through its megakernel view held in the backend's layout."""
    if case == "deep17":
        net = random_net(17, (16,) * 17 + (5,), lo=-4, hi=6)
        x = images(17, 40, 16)
    elif case == "all_negative":
        w = -np.random.default_rng(5).integers(1, 6, size=(40, 6)).astype(np.int32)
        net = jquantize.QuantizedNet(weights=[w])
        x = images(5, 9, 40)
        x[:, :8] = 255
    else:
        w1 = np.ones((4, 2), np.int64)
        w1[:, 0] = 2 ** 30
        net = jquantize.QuantizedNet(weights=[w1.astype(np.int32),
                                              np.array([[5, 0], [0, 1]], np.int32)],
                                     input_threshold=127)
        x = np.full((3, 4), 255, np.uint8)
    view = _view(net)
    got, pallas = _forward_both(x, view.arrays, view.input_threshold, view.n_classes)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jquantize.predict_quantized(net)(jnp.asarray(x))))
    if case == "wrap":
        assert got.tolist() == [1, 1, 1]


def test_forward_table_writes_the_column_stride():
    """The fourth int of a table row is the planes' column stride: W
    rounded up to 8 words in the backend's layout, 1 row-major."""
    rng = np.random.default_rng(3)
    arrays = _random_planes(rng, (3,), 4, (25, 16), 10)
    held = [ops.plane_mma_weights(_t(a)) for a in arrays]
    rows = ops.ForwardTable(held).rows
    assert (rows[:, 3] >> 32).tolist() == [32, 16]
    assert (rows[:, 3] & 0xFFFFFFFF).tolist() == [512, 10]
    assert (rows[:, 2] >> 32).tolist() == [25, 16]
    assert (ops.ForwardTable([_t(a) for a in arrays]).rows[:, 3] >> 32).tolist() == [1, 1]


def _parent_takes(words: int, bm: int) -> bool:
    """The rule `check_forward_planes` had before the tensor-core route:
    two bm x words buffers and 8 warps' (value, index) partials."""
    return 4 * (2 * bm * words + 2 * 8 * bm) <= 232_448


@pytest.mark.parametrize("bm", [8, 32])
def test_check_forward_planes_takes_what_it_took(bm):
    """Every widest-layer width the parent took at this bm is still taken,
    up to the boundary, and the first beyond it is refused; nets over the
    tensor-core route's shared memory take the scalar route."""
    edge = max(w for w in range(1, 8000) if _parent_takes(w, bm))
    for w in (1, 25, 512, edge - 1, edge):
        assert ops.check_forward_planes([w, 1], bm) == bm
    with pytest.raises(ValueError):
        ops.check_forward_planes([edge + 1, 1], bm)
    assert ops.forward_on_mma([4, 4, 4], [25, 16, 1], bm)
    assert not ops.forward_on_mma([1, 1], [edge, 1], bm)   # staged planes overflow
    for p in (1, 4, 8):
        mma_edge = max(w for w in range(1, 8000) if ops.forward_on_mma([p], [w], bm))
        assert ops.forward_mma_smem_bytes([p], [mma_edge], bm) <= 232_448
        assert ops.forward_mma_smem_bytes([p], [mma_edge + 1], bm) > 232_448
        assert ops.check_forward_planes([mma_edge + 1], bm) == bm   # the scalar route
    for bm_all in ops.BLOCK_ROWS:          # the whole parent rule, every bm
        for w in range(1, 4000, 37):
            if _parent_takes(w, bm_all):
                assert ops.check_forward_planes([w], bm_all) == bm_all


def test_forward_cluster_and_route_follow_the_shapes():
    assert ops.forward_cluster([25, 16, 1]) == 8      # 784-500-10: 16 hidden words
    assert ops.forward_cluster([1] * 17) == 1         # width-16 deep nets
    assert ops.forward_cluster([25]) == 1             # no hidden layer
    assert ops.forward_cluster([4, 3, 1]) == 2
    assert ops.forward_on_mma([3] * 40, [1] * 40)
    assert ops.forward_stage_words([4, 4], [25, 16]) == 2 * 4 * 32 * 32
    x = _t(images(3, 4, 40))
    arrays = [_t(a) for a in _view(random_net(3, (40, 21, 7), lo=-5, hi=5)).arrays]
    with pytest.raises(ValueError):
        ops.binary_forward_planes(x, *arrays, threshold=128, n_classes=7, cluster=3)


def _fragment_repack(acc: np.ndarray) -> np.ndarray:
    """numpy model of the tensor-core kernel's step and repack: acc int32
    (16 or 32 rows, N) in m16n8 C fragments (lane (g, t) holds units 2t,
    2t+1 of rows g and g+8), two OR-shuffles across the four lanes of a
    row, and lanes t = 0, 1 storing the byte of rows g, g+8 at byte n0 / 8.
    Returns the rows' uint32 words."""
    rows, n = acc.shape
    out = np.zeros((rows, n // 8), np.uint8)
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for mt in range(rows // 16):
        for n0 in range(0, n, 8):
            c = [acc[mt * 16 + g + 8 * h, n0 + 2 * t + j] for h in (0, 1) for j in (0, 1)]
            lo = ((c[0] > 0) | (c[1] > 0).astype(np.uint32) << 1).astype(np.uint32) << (2 * t)
            hi = ((c[2] > 0) | (c[3] > 0).astype(np.uint32) << 1).astype(np.uint32) << (2 * t)
            for o in (1, 2):
                lo, hi = lo | lo[lanes ^ o], hi | hi[lanes ^ o]
            for lane in lanes[t < 2]:
                out[mt * 16 + g[lane] + 8 * t[lane], n0 // 8] = (hi if t[lane] else lo)[lane]
    return out.view("<u4")


@pytest.mark.parametrize("rows,n", [(16, 32), (16, 512), (32, 96)])
def test_fragment_repack_model_equals_step_pack(rows, n):
    acc = np.random.default_rng(rows + n).integers(-3, 4, size=(rows, n)).astype(np.int32)
    acc[0, :] = 0                                           # zeros step to 0
    want = ref.step_pack(torch.from_numpy(acc), words=n // 32)
    np.testing.assert_array_equal(_fragment_repack(acc), _u32(want))


def test_pixel_bits_multiply_packs_four_flags():
    """The kernel's binarize turns the four byte flags of a word (bit 8j)
    into bits 0-3 with one multiply: ((m & 0x01010101) * 0x10204080) >> 28."""
    for bits in range(16):
        m = sum(0xFF << (8 * j) for j in range(4) if bits >> j & 1)
        assert (((m & 0x01010101) * 0x10204080) & 0xFFFFFFFF) >> 28 == bits


def test_cpu_calls_launch_no_kernel():
    ops.reset_launches()
    net = random_net(8, (40, 6), lo=-5, hi=5)
    view = _view(net)
    ops.binary_forward_planes(_t(images(8, 3, 40)), *[_t(a) for a in view.arrays],
                              threshold=128, n_classes=6)
    x, w = torch.ones((2, 64), dtype=torch.int8), torch.ones((64, 3), dtype=torch.int32)
    ops.binary_matmul(x, w)
    ops.binary_matmul_packed(ops.pack_bits(x), w)
    ops.binary_matmul(x, w.to(torch.int8))
    ops.binary_matmul_packed(ops.pack_bits(x), w.to(torch.int8))
    for wrapper in (ops.binary_forward_planes, ops.binary_matmul_planes,
                    ops.binary_matmul, ops.binary_matmul_packed):
        assert wrapper.launches == 0
    assert ops.binary_matmul.mma_launches == ops.binary_matmul_packed.mma_launches == 0


@pytest.mark.parametrize("family", ["binary_matvec", "fused_mlp", "ssd_scan", "quant_matmul"])
def test_failed_build_raises(monkeypatch, tmp_path, family):
    """No nvcc, or an nvcc that fails, raises: nothing falls back. Each
    kernel family's library builds through the shared nvcc core."""
    import importlib
    from repro_torch.kernels import nvcc
    build = importlib.import_module(f"repro_torch.kernels.{family}.build")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.LIBRARY, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    monkeypatch.setattr(nvcc, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.load()
    assert build.LIBRARY._lib is None and not list(tmp_path.glob("*.so"))
    assert build.SOURCE.is_file() and build.last_build() is None
