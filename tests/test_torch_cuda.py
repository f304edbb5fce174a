"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: every test skips without a CUDA device (the check runs in
a fixture, not at import). On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed. Every comparison of the netgen kernels and of
`quant_matmul` is exact (integer paths); `ssd_scan` states its tolerance.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import netgen
from repro_torch.core import quantize
from repro_torch.kernels.binary_matvec import ops, ref
from repro_torch.kernels.fused_mlp import ops as fops
from repro_torch.kernels.fused_mlp import ref as fref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _words(rng, shape, dev):
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _net(seed, sizes, lo=-5, hi=5):
    rng = np.random.default_rng(seed)
    return quantize.QuantizedNet(weights=[
        rng.integers(lo, hi + 1, size=s).astype(np.int32)
        for s in zip(sizes, sizes[1:])])


def _images(seed, b, n_in):
    return np.random.default_rng(seed + 99).integers(
        0, 256, size=(b, n_in)).astype(np.uint8)


@pytest.mark.parametrize("b,kw,n,p,bm,bn", [
    (5, 3, 10, 1, 8, 128), (37, 33, 45, 4, 1, 32), (256, 25, 500, 4, 8, 128),
    (100, 70, 97, 6, 32, 64), (3, 1, 1, 2, 16, 1024), (9, 40, 300, 3, 4, 96)])
def test_matmul_planes_kernel_matches_plain(cuda, b, kw, n, p, bm, bn):
    rng = np.random.default_rng(b + kw + n)
    x, pos, neg = (_words(rng, s, cuda) for s in ((b, kw), (p, kw, n), (p, kw, n)))
    before = ops.binary_matmul_planes.launches
    got = ops.binary_matmul_planes(x, pos, neg, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert ops.binary_matmul_planes.launches == before + 1
    assert torch.equal(got, ref.plane_matmul(x, pos, neg))
    assert torch.equal(got.cpu(), ops.binary_matmul_planes(x.cpu(), pos.cpu(), neg.cpu()))


@pytest.mark.parametrize("sizes,bm", [((40, 6), 8), ((45, 21, 7), 1),
                                      ((33, 40, 12, 5), 32), ((784, 500, 10), 8),
                                      ((70, 65, 9), 4)])
def test_forward_planes_kernel_matches_plain(cuda, sizes, bm):
    net = _net(len(sizes) + bm, sizes)
    view = netgen.lower_circuit(netgen.lower(net)).megakernel_view()
    arrays = [torch.from_numpy(a.view(np.int32)).to(cuda) for a in view.arrays]
    x = torch.from_numpy(_images(bm, 77, sizes[0])).to(cuda)
    kw = {"threshold": view.input_threshold, "n_classes": view.n_classes}
    got = ops.binary_forward_planes(x, *arrays, bm=bm, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.forward_planes(x, *arrays, **kw))
    want = quantize.predict_quantized(net, device=cuda)(x)
    assert want.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("depth", [17, 40])
def test_forward_planes_kernel_takes_deep_nets(cuda, depth):
    """No depth cap: a width-16 net of 17 or 40 layers through the
    megakernel (its layer table in device memory, built once) equals the
    plain chain, `predict_quantized` and the `cuda[fusednet=true]` target."""
    net = _net(depth, (16,) * depth + (5,), lo=-4, hi=6)
    view = netgen.lower_circuit(netgen.lower(net)).megakernel_view()
    arrays = [torch.from_numpy(a.view(np.int32)).to(cuda) for a in view.arrays]
    table = ops.ForwardTable(arrays)
    x = torch.from_numpy(_images(depth, 300, 16)).to(cuda)
    kw = {"threshold": view.input_threshold, "n_classes": view.n_classes}
    before = ops.binary_forward_planes.launches
    mma = ops.binary_forward_planes.mma_launches
    got = ops.binary_forward_planes(x, *arrays, table=table, **kw)
    again = ops.binary_forward_planes(x, *arrays, **kw)
    torch.cuda.synchronize()
    assert ops.binary_forward_planes.launches == before + 2
    assert ops.binary_forward_planes.mma_launches == mma + 2    # the tensor-core route
    assert torch.equal(got, again)
    assert torch.equal(got, ref.forward_planes(x, *arrays, **kw))
    assert torch.equal(got, quantize.predict_quantized(net, device=cuda)(x))
    art = netgen.Session(device=cuda).compile(net, target="cuda[fusednet=true]")
    assert torch.equal(art(x), got)
    with pytest.raises(ValueError):           # a table of other tensors
        ops.binary_forward_planes(x, *arrays, table=ops.ForwardTable(arrays[:2]), **kw)


def test_forward_planes_kernel_stacked_and_random_words(cuda):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (3, 70, 100), dtype=np.uint8)).to(cuda)
    planes = []
    for p, w, n in ((4, 4, 64), (2, 2, 32), (3, 1, 11)):
        planes += [_words(rng, (3, p, w, n), cuda) for _ in range(2)]
    kw = {"threshold": 128, "n_classes": 11}
    got = ops.binary_forward_planes(x, *planes, **kw)
    torch.cuda.synchronize()
    assert got.shape == (3, 70)
    assert torch.equal(got, ref.forward_planes(x, *planes, **kw))


def test_forward_planes_kernel_all_scores_negative(cuda):
    w = -np.random.default_rng(5).integers(1, 6, size=(40, 6)).astype(np.int32)
    view = netgen.lower_circuit(netgen.lower([w])).megakernel_view()
    x = _images(5, 33, 40)
    x[:, :8] = 255
    arrays = [torch.from_numpy(a.view(np.int32)).to(cuda) for a in view.arrays]
    got = ops.binary_forward_planes(torch.from_numpy(x).to(cuda), *arrays,
                                    threshold=128, n_classes=6)
    scores = (x.astype(np.int64) > 128) @ w
    assert (scores < 0).all()
    np.testing.assert_array_equal(got.cpu().numpy(), np.argmax(scores, axis=1))


# -- binary_forward_planes: the 1-bit tensor-core route and the scalar route --

def _random_planes(rng, lead, p, words, n_classes, dev):
    arrays = []
    for i, w in enumerate(words):
        n = n_classes if i + 1 == len(words) else 32 * words[i + 1]
        arrays += [_words(rng, (*lead, p, w, n), dev) for _ in range(2)]
    return arrays


def _scalar_forward(x, planes, threshold, n_classes, bm=8):
    """The scalar kernel (`bmv_forward_planes`) on row-major planes,
    called directly: the op takes it only where the tensor-core route's
    shared memory cannot hold the activations."""
    from repro_torch.kernels.binary_matvec import build
    table = ops.ForwardTable(planes)
    out = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
    m = x.shape[0] if x.dim() == 3 else 1
    words = [p.shape[-2] for p in planes[0::2]]
    err = build.load().bmv_forward_planes(
        x.data_ptr(), m, x.shape[-2], x.shape[-1], threshold, table.rows.data_ptr(),
        len(words), max(words), n_classes, out.data_ptr(), bm, x.device.index,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


@pytest.mark.parametrize("lead,b,p,words,k", [
    ((), 1, 4, (2, 16, 1), 50), ((), 17, 4, (2, 16, 1), 50), ((), 255, 4, (2, 16, 1), 50),
    ((3,), 1, 4, (2, 16, 1), 64), ((3,), 17, 2, (2, 4, 1), 64), ((2,), 255, 3, (2, 1, 1), 40),
    ((), 40, 1, (1, 1, 1), 32), ((), 40, 2, (2, 32, 1), 33), ((), 40, 3, (3, 2, 4, 1), 70),
    ((), 40, 5, (1, 8, 1), 20), ((), 40, 6, (1, 3, 1), 20), ((), 40, 7, (2, 1, 1), 60),
    ((), 40, 8, (1, 2, 1), 31), ((3,), 256, 4, (25, 16, 1), 784),
])
def test_forward_planes_both_routes_match_plain(cuda, lead, b, p, words, k):
    """Random words, single and stacked, B ragged against the tiles, P 1-8,
    hidden widths 32-1024 units, the 784-500-10 shape: the tensor-core
    route on the backend's layout, at both tile heights, and the scalar
    kernel each equal the plain version."""
    rng = np.random.default_rng(b + p + len(words))
    planes = _random_planes(rng, lead, p, words, 10, cuda)
    x = torch.from_numpy(rng.integers(0, 256, (*lead, b, k), dtype=np.uint8)).to(cuda)
    kw = {"threshold": 128, "n_classes": 10}
    want = ref.forward_planes(x, *planes, **kw)
    held = [ops.plane_mma_weights(a) for a in planes]
    for bm in (8, 32):
        before = ops.binary_forward_planes.mma_launches
        got = ops.binary_forward_planes(x, *held, bm=bm, **kw)
        torch.cuda.synchronize()
        assert ops.binary_forward_planes.mma_launches == before + 1
        assert torch.equal(got, want), bm
    assert torch.equal(_scalar_forward(x, planes, **kw), want)


def test_forward_planes_every_cluster_and_tile(cuda):
    """Every cluster size at both tile heights gives the same classes at
    the 784-500-10 stacked shape; the C entry's shared memory equals
    ops.py's mirror."""
    from repro_torch.kernels.binary_matvec import build
    rng = np.random.default_rng(21)
    planes = [ops.plane_mma_weights(a)
              for a in _random_planes(rng, (3,), 4, (25, 16), 10, cuda)]
    x = torch.from_numpy(rng.integers(0, 256, (3, 256, 784), dtype=np.uint8)).to(cuda)
    kw = {"threshold": 128, "n_classes": 10}
    want = ref.forward_planes(x, *planes, **kw)
    for bm in (8, 32):
        for cluster in ops.FORWARD_CLUSTERS:
            got = ops.binary_forward_planes(x, *planes, bm=bm, cluster=cluster, **kw)
            assert torch.equal(got, want), (bm, cluster)
        picked = ops.launch_cluster([4, 4], [25, 16], 256, 3, bm, cuda)
        assert picked in ops.FORWARD_CLUSTERS and picked <= ops.forward_cluster([25, 16])
    lib = build.load()
    for p in (1, 4, 8):
        for w in (1, 8, 16, 25, 99, 100):
            stage = ops.forward_stage_words([p], [w])
            assert lib.bmv_forward_stage_words(p, w) == stage
            for bm in ops.BLOCK_ROWS:
                assert lib.bmv_forward_mma_smem_bytes(bm, w, stage) \
                    == ops.forward_mma_smem_bytes([p], [w], bm)


def test_forward_planes_routes_by_shape(cuda):
    """Row-major planes are copied into the tensor-core layout and are
    exact; a net whose activations overflow that route's shared memory at
    bm=8 takes the scalar kernel and is exact too."""
    rng = np.random.default_rng(22)
    kw = {"threshold": 100, "n_classes": 6}
    planes = _random_planes(rng, (), 3, (25, 16), 6, cuda)
    x = torch.from_numpy(rng.integers(0, 256, (70, 784), dtype=np.uint8)).to(cuda)
    before = ops.binary_forward_planes.mma_launches
    got = ops.binary_forward_planes(x, *planes, table=ops.ForwardTable(planes), **kw)
    torch.cuda.synchronize()
    assert ops.binary_forward_planes.mma_launches == before + 1
    assert torch.equal(got, ref.forward_planes(x, *planes, **kw))
    wide = _random_planes(rng, (), 2, (2000, 1), 6, cuda)
    assert not ops.forward_on_mma([2, 2], [2000, 1], 8)
    assert ops.check_forward_planes([2000, 1], 8) == 8
    x = torch.from_numpy(rng.integers(0, 256, (40, 2000 * 32), dtype=np.uint8)).to(cuda)
    want = ref.forward_planes(x, *wide, **kw)
    launches, mma = ops.binary_forward_planes.launches, ops.binary_forward_planes.mma_launches
    assert torch.equal(ops.binary_forward_planes(x, *wide, bm=8, **kw), want)
    assert ops.binary_forward_planes.launches == launches + 1
    assert ops.binary_forward_planes.mma_launches == mma
    held = [ops.plane_mma_weights(a) for a in wide]    # copied back to row-major
    assert torch.equal(ops.binary_forward_planes(x, *held, bm=8, **kw), want)
    assert ops.binary_forward_planes.mma_launches == mma


def test_served_784_500_10_takes_the_tensor_cores(cuda, monkeypatch):
    """Every `binary_forward_planes` launch of stacked `cuda[planes=true]`
    rounds over 784-500-10 nets takes the tensor-core route, and the
    wrapping net gives class 1 through `cuda[fusednet=true]` on it (its
    range proof fails, so it compiles in the production posture)."""
    nets = {f"v{i}": _net(30 + i, (784, 500, 10), lo=-9, hi=9) for i in range(3)}
    server = netgen.NetServer(session=netgen.Session(device=cuda),
                              target="cuda[planes=true]", slot_capacity=256)
    for name, net in nets.items():
        server.register(name, net)
    ops.reset_launches()
    x = _images(5, 256, 784)
    for _ in range(2):
        out = server.predict_many({"v0": x, "v1": x[:200], "v2": x[:17]})
    assert ops.binary_forward_planes.launches == 2
    assert ops.binary_forward_planes.mma_launches == 2
    for name, req in (("v0", x), ("v1", x[:200]), ("v2", x[:17])):
        want = quantize.predict_quantized(nets[name], device=cuda)(req)
        np.testing.assert_array_equal(out[name], want.cpu().numpy())
    w1 = np.ones((4, 2), np.int64)
    w1[:, 0] = 2 ** 30
    wrap = quantize.QuantizedNet(weights=[w1.astype(np.int32),
                                          np.array([[5, 0], [0, 1]], np.int32)],
                                 input_threshold=127)
    with pytest.raises(netgen.VerificationError, match="range.int32"):
        netgen.Session(device=cuda).compile(wrap, target="cuda[fusednet=true]")
    monkeypatch.setenv("NETGEN_VERIFY", "0")
    art = netgen.Session(device=cuda).compile(wrap, target="cuda[fusednet=true]")
    mma = ops.binary_forward_planes.mma_launches
    assert art(np.full((3, 4), 255, np.uint8)).tolist() == [1, 1, 1]
    assert ops.binary_forward_planes.mma_launches == mma + 1


@pytest.mark.parametrize("target,wrapper", [
    ("cuda[fusednet=true]", "binary_forward_planes"),
    ("cuda[planes=true]", "binary_matmul_planes")])
def test_addend_form_nets_on_the_card_equal_the_interpreter(cuda, target, wrapper):
    """A random 784-wide net in the multiplication-free addend form
    (`zeros,prune,addends`) lowers to the same planes as its `default`
    form, and the card's answers equal the numpy interpreter's strict
    semantics; a CSE'd net has no layered form and raises."""
    net = _net(40, (784, 96, 10), lo=-7, hi=7)
    session = netgen.Session(device=cuda)
    x = _images(40, 300, 784)
    ops.reset_launches()
    art = session.compile(net, target=target, pipeline="zeros,prune,addends")
    got = art(x).cpu().numpy()
    launches = getattr(ops, wrapper).launches
    assert launches > 0
    if wrapper == "binary_forward_planes":
        assert ops.binary_forward_planes.mma_launches == launches
    want = netgen.evaluate(art.circuit, x, step_semantics="strict")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, quantize.predict_quantized(net, device=cuda)(x).cpu().numpy())
    plain = session.compile(net, target=target).plan().planes()
    for a, b in zip(art.plan().planes().layers, plain.layers):
        np.testing.assert_array_equal(a.pos_planes, b.pos_planes)
        np.testing.assert_array_equal(a.neg_planes, b.neg_planes)
    with pytest.raises(netgen.IrregularCircuitError):
        session.compile(net, target=target, pipeline="zeros,cse[budget=4,bucketed=true]")


def test_noncontiguous_operands_raise(cuda):
    """Strided activations raise; planes in any layout are copied into the
    K-major one and give the same words."""
    rng = np.random.default_rng(2)
    x = _words(rng, (8, 12), cuda)
    pos = _words(rng, (2, 6, 64), cuda)
    with pytest.raises(ValueError):
        ops.binary_matmul_planes(x[:, ::2], pos, pos)
    got = ops.binary_matmul_planes(x[:, :6].contiguous(), pos[..., ::2], pos[..., 1::2])
    assert torch.equal(got, ref.plane_matmul(x[:, :6], pos[..., ::2], pos[..., 1::2]))
    with pytest.raises(TypeError):
        ops.binary_matmul_planes(x[:, :6].contiguous(), pos.long(), pos.long())
    with pytest.raises(ValueError):        # 64 planes overflow a block's shared memory
        big = _words(rng, (64, 6, 8), cuda)
        ops.binary_matmul_planes(x[:, :6].contiguous(), big, big)


def test_matmul_planes_kernel_takes_every_block_shape(cuda):
    """Every (bm, bn) `check_matmul_blocks` accepts maps onto a 1-bit
    tensor-core tile, bm=32, bn=1024 included."""
    rng = np.random.default_rng(13)
    x, pos, neg = (_words(rng, s, cuda) for s in ((70, 25), (4, 25, 150), (4, 25, 150)))
    pos, neg = ops.plane_mma_weights(pos), ops.plane_mma_weights(neg)
    want = ref.plane_matmul(x, pos, neg)
    for bm in ops.BLOCK_ROWS:
        for bn in range(32, 1025, 32):
            assert ops.check_matmul_blocks(bm, bn) == (bm, bn)
            assert torch.equal(ops.binary_matmul_planes(x, pos, neg, bm=bm, bn=bn), want), (bm, bn)


@pytest.mark.parametrize("p", range(1, 9))
def test_matmul_planes_kernel_every_plane_count(cuda, p):
    """P from 1 to 8 at the layer-1 width, the backend's K-major layout and
    row-major planes alike."""
    rng = np.random.default_rng(30 + p)
    x, pos, neg = (_words(rng, s, cuda) for s in ((256, 25), (p, 25, 500), (p, 25, 500)))
    want = ref.plane_matmul(x, pos, neg)
    from repro_torch.kernels.binary_matvec import build
    for bm in (16, 32):              # ops.py's mirror of the kernel's shared memory
        assert build.load().bmv_planes_smem_bytes(bm, p) == ops.planes_smem_bytes(bm, p)
    before = ops.binary_matmul_planes.launches
    got = ops.binary_matmul_planes(x, ops.plane_mma_weights(pos), ops.plane_mma_weights(neg))
    torch.cuda.synchronize()
    assert ops.binary_matmul_planes.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(ops.binary_matmul_planes(x, pos, neg), want)


def test_matmul_planes_kernel_wraps_like_int32(cuda):
    """24 planes of mostly set words: the column sums pass 2^31 and wrap
    as the int32 reference does."""
    rng = np.random.default_rng(14)
    b, kw, n, p = 40, 40, 70, 24
    x = torch.full((b, kw), -1, dtype=torch.int32, device=cuda)
    pos = torch.full((p, kw, n), -1, dtype=torch.int32, device=cuda)
    neg = _words(rng, (p, kw, n), cuda) & 0xFFFF
    want = ref.plane_matmul(x, pos, neg)
    got = ops.binary_matmul_planes(x, ops.plane_mma_weights(pos), ops.plane_mma_weights(neg))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    exact = (ref.popcount(pos).sum(1) - ref.popcount(neg).sum(1)) \
        << torch.arange(p, device=cuda)[:, None]
    assert bool((exact.sum(0) >= 2 ** 31).all())


def test_served_path_runs_both_kernels(cuda):
    nets = {f"v{i}": _net(10 + i, (120, 50 + 7 * i, 10)) for i in range(3)}
    server = netgen.NetServer(session=netgen.Session(device=cuda),
                              target="cuda[planes=true]", slot_capacity=64)
    for name, net in nets.items():
        server.register(name, net)
    ops.reset_launches()
    x = _images(3, 150, 120)
    out = server.predict_many({"v0": x, "v1": x[:70], "v2": x[:9]})
    single = server.predict("v2", x)
    assert ops.binary_forward_planes.launches > 0
    assert ops.binary_matmul_planes.launches > 0
    for name, req in (("v0", x), ("v1", x[:70]), ("v2", x[:9])):
        want = quantize.predict_quantized(nets[name], device=cuda)(req)
        np.testing.assert_array_equal(out[name], want.cpu().numpy())
    np.testing.assert_array_equal(
        single, quantize.predict_quantized(nets["v2"], device=cuda)(x).cpu().numpy())


@pytest.mark.parametrize("b,k,n,bm,bn,wdtype", [
    (5, 70, 10, 4, 128, torch.int32), (37, 784, 500, 1, 32, torch.int32),
    (256, 784, 500, 4, 128, torch.int32), (256, 500, 10, 4, 128, torch.int32),
    (100, 300, 97, 32, 64, torch.int8), (3, 1, 1, 16, 1024, torch.int32),
    (9, 1000, 300, 8, 96, torch.int8), (64, 513, 33, 2, 32, torch.int32),
    (40, 300, 70, 32, 1024, torch.int32)])
def test_matmul_dense_kernel_matches_plain(cuda, b, k, n, bm, bn, wdtype):
    """K past one staged chunk and not a multiple of 4, N ragged, and
    activations that are any nonzero byte."""
    rng = np.random.default_rng(b + k + n)
    x = torch.from_numpy(rng.integers(-2, 3, size=(b, k)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-9, 10, size=(k, n))).to(wdtype).to(cuda)
    before = ops.binary_matmul.launches
    got = ops.binary_matmul(x, w, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert ops.binary_matmul.launches == before + 1
    assert torch.equal(got, ref.binary_matmul(x, w))
    assert torch.equal(got.cpu(), ops.binary_matmul(x.cpu(), w.cpu()))


@pytest.mark.parametrize("b,kw,n,bm,bn,wdtype", [
    (5, 3, 10, 4, 128, torch.int32), (256, 25, 500, 4, 128, torch.int32),
    (256, 16, 10, 1, 32, torch.int32), (100, 40, 97, 32, 64, torch.int8),
    (3, 1, 1, 16, 1024, torch.int32), (9, 70, 300, 8, 96, torch.int8),
    (40, 30, 70, 32, 1024, torch.int32)])
def test_matmul_packed_kernel_matches_plain(cuda, b, kw, n, bm, bn, wdtype):
    """Random words, bit 31 included (a logical shift, never a sign
    extension), KW past one staged chunk."""
    rng = np.random.default_rng(b + kw + n)
    xp = _words(rng, (b, kw), cuda)
    w = torch.from_numpy(rng.integers(-9, 10, size=(kw * 32, n))).to(wdtype).to(cuda)
    before = ops.binary_matmul_packed.launches
    got = ops.binary_matmul_packed(xp, w, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert ops.binary_matmul_packed.launches == before + 1
    assert torch.equal(got, ref.binary_matmul_packed(xp, w))


def test_matmul_kernels_wrap_like_int32(cuda):
    rng = np.random.default_rng(9)
    x = torch.ones((3, 96), dtype=torch.int8, device=cuda)
    w = torch.from_numpy(rng.integers(2 ** 29, 2 ** 31 - 1, size=(96, 5)).astype(np.int32)).to(cuda)
    want = ref.binary_matmul(x, w)
    mma = ops.binary_matmul.mma_launches, ops.binary_matmul_packed.mma_launches
    assert torch.equal(ops.binary_matmul(x, w), want)
    assert torch.equal(ops.binary_matmul_packed(ops.pack_bits(x), w), want)
    # int32 weights take the scalar route
    assert (ops.binary_matmul.mma_launches, ops.binary_matmul_packed.mma_launches) == mma


def _int8_operands(rng, b, k, n, dev):
    """Activations in -2..2 (nonzero means 1) and int8 weights over the
    whole range, with a row at -128 and a row at 127."""
    x = torch.from_numpy(rng.integers(-2, 3, size=(b, k)).astype(np.int8)).to(dev)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    w[0], w[-1] = -128, 127
    return x, torch.from_numpy(w).to(dev)


@pytest.mark.parametrize("b,k,n", [
    (256, 784, 500), (256, 500, 10), (37, 784, 77), (5, 70, 10), (100, 70, 500),
    (17, 1000, 8), (1, 33, 1), (300, 784, 10), (64, 20, 1030)])
def test_matmul_mma_kernels_match_plain(cuda, b, k, n):
    """The tensor-core routes of both wrappers at ragged shapes: B not a
    multiple of 16, K not a multiple of 32 (and of 16 or 4: the staging
    falls back from 16- to 4- to 1-byte copies), N not a multiple of 8."""
    rng = np.random.default_rng(b * 7 + k + n)
    x, w = _int8_operands(rng, b, k, n, cuda)
    want = ref.binary_matmul(x, w)
    before = ops.binary_matmul.launches, ops.binary_matmul.mma_launches
    got = ops.binary_matmul(x, w)
    torch.cuda.synchronize()
    assert (ops.binary_matmul.launches, ops.binary_matmul.mma_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert torch.equal(got, ops.binary_matmul(x, w.int()))
    assert torch.equal(got, ops.binary_matmul(x, ops.mma_weights(w)))
    xp = ops.pack_bits(x)
    wp = torch.zeros((xp.shape[1] * 32, n), dtype=torch.int8, device=cuda)
    wp[:k] = w
    before = ops.binary_matmul_packed.mma_launches
    got = ops.binary_matmul_packed(xp, wp)
    torch.cuda.synchronize()
    assert ops.binary_matmul_packed.mma_launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, ref.binary_matmul_packed(xp, wp))
    assert torch.equal(got, ops.binary_matmul_packed(xp, ops.mma_weights(wp)))


def test_matmul_mma_kernels_take_every_block_shape(cuda):
    """Every (bm, bn) the wrappers accept maps onto a tensor-core tile."""
    rng = np.random.default_rng(11)
    x, w = _int8_operands(rng, 70, 300, 150, cuda)
    xp = ops.pack_bits(x)
    wp = torch.zeros((xp.shape[1] * 32, 150), dtype=torch.int8, device=cuda)
    wp[:300] = w
    want = ref.binary_matmul(x, w)
    for bm in ops.BLOCK_ROWS:
        for bn in range(32, 1025, 32):
            assert torch.equal(ops.binary_matmul(x, w, bm=bm, bn=bn), want), (bm, bn)
            assert torch.equal(ops.binary_matmul_packed(xp, wp, bm=bm, bn=bn), want), (bm, bn)


@pytest.mark.parametrize("wdtype,lo,hi", [(torch.int32, -9, 9), (torch.int8, -9, 9),
                                          (torch.int8, -128, 127)])
@pytest.mark.parametrize("b,k,h,o,bm,thr", [
    (256, 784, 500, 10, None, 128), (37, 784, 500, 10, 1, 0), (9, 45, 21, 7, 8, 254),
    (100, 70, 1100, 12, 32, 100), (3, 33, 40, 1, 4, 128), (64, 1000, 64, 30, 16, 50),
    (17, 130, 9, 3, 2, -1), (300, 800, 520, 11, 8, 255)])
def test_fused_kernel_matches_plain(cuda, b, k, h, o, bm, thr, wdtype, lo, hi):
    """Both routes: int32 weights on the scalar kernel, int8 (|w| <= 9 and
    the whole int8 range) on the tensor cores, in the `mma_weights` layout
    (w1 and w2) and row-major (copied per call). The paper shape at the
    default block, H wider than the block's threads or than a cluster's
    sub-tiles, one class, K, H, O and B ragged, thresholds past both ends."""
    rng = np.random.default_rng(b + k + h)
    x = torch.from_numpy(_images(b, b, k)).to(cuda)
    w1 = torch.from_numpy(rng.integers(lo, hi + 1, size=(k, h))).to(wdtype).to(cuda)
    w2 = torch.from_numpy(rng.integers(lo, hi + 1, size=(h, o))).to(wdtype).to(cuda)
    if lo == -128:
        w1[0], w2[-1] = -128, 127
    want = fref.fused_mlp_predict(x, w1, w2, threshold=thr)
    layouts = [(w1, w2)]
    if wdtype == torch.int8:
        layouts.append((ops.mma_weights(w1), ops.mma_weights(w2)))
    for a1, a2 in layouts:
        launches, mma = fops.fused_mlp_predict.launches, fops.fused_mlp_predict.mma_launches
        got = fops.fused_mlp_predict(x, a1, a2, threshold=thr, bm=bm)
        torch.cuda.synchronize()
        assert fops.fused_mlp_predict.launches == launches + 1
        assert fops.fused_mlp_predict.mma_launches == mma + int(wdtype == torch.int8)
        assert torch.equal(got, want)


@pytest.mark.parametrize("wdtype", [torch.int32, torch.int8])
def test_fused_kernel_all_scores_negative(cuda, wdtype):
    rng = np.random.default_rng(4)
    w1 = torch.from_numpy(rng.integers(-9, 10, size=(40, 16))).to(wdtype).to(cuda)
    w2 = torch.from_numpy(-rng.integers(1, 6, size=(16, 6))).to(wdtype).to(cuda)
    x = _images(3, 9, 40)
    x[:, :8] = 255
    x = torch.from_numpy(x).to(cuda)
    got = fops.fused_mlp_predict(x, w1, w2, threshold=128)
    assert torch.equal(got, fref.fused_mlp_predict(x, w1, w2, threshold=128))


@pytest.mark.parametrize("wdtype", [torch.int32, torch.int8])
def test_fused_kernel_ties_go_to_the_lower_class(cuda, wdtype):
    """Equal class scores summed across the cluster's blocks: the first
    maximum wins, also when the tie spans hidden units of several blocks."""
    w1 = torch.ones((8, 600), dtype=wdtype, device=cuda)
    w2 = torch.tensor([[1, 3, 3, 2]] * 600, dtype=wdtype, device=cuda)
    x = torch.full((40, 8), 200, dtype=torch.uint8, device=cuda)
    got = fops.fused_mlp_predict(x, w1, w2, threshold=128)
    assert torch.equal(got, torch.ones(40, dtype=torch.int32, device=cuda))
    assert torch.equal(got, fref.fused_mlp_predict(x, w1, w2, threshold=128))


@pytest.mark.parametrize("target,wrapper", [
    ("cuda", ops.binary_matmul), ("cuda[packed=true]", ops.binary_matmul_packed),
    ("fused", fops.fused_mlp_predict)])
def test_served_path_runs_each_new_kernel(cuda, target, wrapper):
    nets = {f"v{i}": _net(20 + i, (120, 50 + 7 * i, 10)) for i in range(3)}
    server = netgen.NetServer(session=netgen.Session(device=cuda),
                              target=target, slot_capacity=64)
    for name, net in nets.items():
        server.register(name, net)
    ops.reset_launches()
    fops.reset_launches()
    x = _images(4, 150, 120)
    out = server.predict_many({"v0": x, "v1": x[:70], "v2": x[:9]})
    single = server.predict("v1", x)
    assert wrapper.launches > 0
    assert wrapper.mma_launches == wrapper.launches    # |w| <= 5 fits int8
    for name, req in (("v0", x), ("v1", x[:70]), ("v2", x[:9])):
        want = quantize.predict_quantized(nets[name], device=cuda)(req)
        np.testing.assert_array_equal(out[name], want.cpu().numpy())
    np.testing.assert_array_equal(
        single, quantize.predict_quantized(nets["v1"], device=cuda)(x).cpu().numpy())


@pytest.mark.parametrize("target,wrapper", [
    ("cuda", ops.binary_matmul), ("cuda[packed=true]", ops.binary_matmul_packed),
    ("cuda[fusednet=true]", ops.binary_forward_planes), ("fused", fops.fused_mlp_predict)])
def test_engine_load_and_store_warm_start(cuda, target, wrapper, tmp_path):
    """Single requests through `ServingEngine` on the card, three versions
    interleaved, then a second session over the same store: zero compiles,
    three loads, and every answer equal to `predict_quantized`."""
    nets = {f"v{i}": _net(30 + i, (120, 50 + 7 * i, 10)) for i in range(3)}
    x = _images(5, 90, 120)
    want = {name: quantize.predict_quantized(net, device=cuda)(x).cpu().numpy()
            for name, net in nets.items()}
    session = netgen.Session(device=cuda, store=tmp_path / "store")
    with session, session.engine(target=target, slot_capacity=32,
                                 max_batch_delay=0.002) as engine:
        for name, net in nets.items():
            engine.register(name, net)
        ops.reset_launches()
        fops.reset_launches()
        futs = [(name, i, engine.submit(name, x[i]))
                for i in range(len(x)) for name in nets]
        got = {name: np.full(len(x), -1, np.int64) for name in nets}
        for name, i, fut in futs:
            got[name][i] = fut.result(timeout=60)
    assert engine.stats().completed == 3 * len(x)
    assert wrapper.launches > 0 and wrapper.mma_launches == wrapper.launches
    for name in nets:
        np.testing.assert_array_equal(got[name], want[name])
    assert session.stats().compiles == 3
    warm = netgen.Session(device=cuda, store=tmp_path / "store")
    server = netgen.NetServer(session=warm, target=target, slot_capacity=32)
    for name, net in nets.items():
        server.register(name, net)
    assert warm.stats().compiles == 0 and warm.store_stats().loads == 3
    out = server.predict_many({name: x for name in nets})
    for name in nets:
        np.testing.assert_array_equal(out[name], want[name])


# -- the LM path: ssd_scan (B7) and quant_matmul (B6) ------------------------

def _ssd_inputs(b, l, h, g, p, n, seed, dev, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = t(rng.normal(size=(b, l, h, p))).to(dtype)
    dt = t(rng.uniform(0.001, 0.1, size=(b, l, h))).to(dtype)
    a = t(-rng.uniform(0.5, 2.0, size=(h,)))
    bb = (t(rng.normal(size=(b, l, g, n))) / np.sqrt(n)).to(dtype)
    cc = (t(rng.normal(size=(b, l, g, n))) / np.sqrt(n)).to(dtype)
    return x, dt, a, bb, cc


_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,dtype,mma", [
    (1, 64, 1, 1, 16, 32, 16, _F32, False), (2, 128, 4, 2, 32, 64, 64, _F32, False),
    (2, 64, 8, 8, 16, 16, 32, _F32, False), (1, 256, 2, 1, 64, 128, 128, _F32, False),
    (2, 96, 6, 3, 48, 40, 32, _F32, False), (2, 128, 4, 1, 64, 128, 128, _BF16, True),
    (1, 512, 80, 1, 64, 128, 128, _BF16, True), (1, 64, 1, 1, 16, 32, 16, _BF16, True),
    (2, 128, 4, 2, 32, 64, 64, _BF16, True), (2, 64, 8, 8, 16, 16, 32, _BF16, True),
    (2, 96, 6, 3, 48, 40, 32, _BF16, True), (1, 256, 3, 1, 24, 20, 64, _BF16, True),
    (2, 256, 10, 5, 64, 128, 128, _BF16, True), (1, 128, 2, 1, 80, 16, 64, _BF16, False),
    (1, 96, 2, 1, 16, 16, 24, _BF16, False), (1, 64, 2, 1, 16, 192, 64, _BF16, False)])
def test_ssd_kernel_matches_plain(cuda, b, l, h, g, p, n, chunk, dtype, mma):
    """Both routes: bf16 on the tensor cores (G > 1, several chunks and
    one, Q in {16, 32, 64, 128}, P and N off the 16-column tiles, N not a
    multiple of 8 (staged a value at a time), a full-width mamba2-2.7b
    head count), and fp32 or shapes it refuses (P > 64, Q % 16, N > 128)
    on the scalar kernel. fp32: 1e-4; bf16: y within one bf16 ulp of the
    larger of the two (both round fp32 sums once) plus 1e-5 for the sums'
    order, state 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    args = _ssd_inputs(b, l, h, g, p, n, l + h, cuda, dtype)
    before, before_mma = sops.ssd.launches, sops.ssd.mma_launches
    y, s = sops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sops.ssd.launches == before + 1
    assert sops.ssd.mma_launches == before_mma + int(mma)
    yp, sp = sref.ssd(*args, chunk=chunk)
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(s, sp, rtol=1e-4, atol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    else:
        g, w = y.float(), yp.float()
        ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
        assert bool(((g - w).abs() <= ulp + 1e-5).all())


def test_mixer_pads_ragged_lengths_onto_the_tensor_cores(cuda):
    """A ragged S in bf16: the mixer zero-pads it to a chunk multiple and
    the SSD takes the tensor-core route; output and final state lie within
    4 bf16 ulps of the layer's scale of the plain route (chip_smoke.py's
    per-layer bound)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.layers import mamba2 as m2
    from repro_torch.models import api, base, mamba
    cfg = dataclasses.replace(configs.smoke("mamba2-2.7b"), ssm_state=128, ssm_headdim=64)
    params = base.tree_init(api.abstract_params(cfg),
                            torch.Generator(device=cuda).manual_seed(1), cuda)
    mixer = mamba.layer(params["layers"], 0)["mixer"]
    eps = torch.finfo(torch.bfloat16).eps
    for s_len, chunk in ((100, 64), (200, 128), (77, 16)):
        xin = torch.randn((2, s_len, cfg.d_model), device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(s_len))
        xin = xin.to(torch.bfloat16)
        before = sops.ssd.mma_launches
        ok, sk = m2.mamba_mixer(cfg, mixer, xin, chunk=chunk, use_kernel=True,
                                return_state=True)
        torch.cuda.synchronize()
        assert sops.ssd.mma_launches == before + 1
        op, sp = m2.mamba_mixer(cfg, mixer, xin, chunk=chunk, use_kernel=False,
                                return_state=True)
        for k, p in ((ok.float(), op.float()), (sk["ssm"], sp["ssm"])):
            assert (k - p).abs().max() <= 4 * eps * p.abs().max()


def test_ssd_kernel_reads_the_mixer_layout(cuda):
    """x, B and C as strided views of one conv output, the mixer's layout,
    give the same bits as their contiguous copies on both routes; L % chunk
    != 0 is refused as in the reference."""
    from repro_torch.kernels.ssd_scan import ops as sops
    rng = np.random.default_rng(3)
    bsz, l, h, p, g, n = 2, 64, 4, 16, 1, 32
    conv = rng.normal(size=(bsz, l, h * p + 2 * g * n)).astype(np.float32)
    conv[..., h * p:] /= 6
    a = -torch.ones(h, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        cv = torch.from_numpy(conv).to(cuda).to(dtype)
        x = cv[..., :h * p].reshape(bsz, l, h, p)
        bb = cv[..., h * p:h * p + g * n].reshape(bsz, l, g, n)
        cc = cv[..., h * p + g * n:].reshape(bsz, l, g, n)
        assert not x.is_contiguous() and not bb.is_contiguous()
        dt = torch.full((bsz, l, h), 0.05, device=cuda, dtype=dtype)
        y, s = sops.ssd(x, dt, a, bb, cc, chunk=32)
        y2, s2 = sops.ssd(x.contiguous(), dt, a, bb.contiguous(), cc.contiguous(), chunk=32)
        assert torch.equal(y, y2) and torch.equal(s, s2)
        with pytest.raises(AssertionError):
            sops.ssd(x[:, :48], dt[:, :48], a, bb[:, :48], cc[:, :48], chunk=32)


def test_ssd_kernel_refuses_bad_operands(cuda):
    from repro_torch.kernels.ssd_scan import ops as sops
    x, dt, a, bb, cc = _ssd_inputs(1, 64, 2, 1, 16, 32, 1, cuda)
    with pytest.raises(ValueError):
        sops.ssd(x[..., ::2], dt, a, bb[..., ::2], cc[..., ::2], chunk=32)
    with pytest.raises(TypeError):
        sops.ssd(x.half(), dt.half(), a, bb.half(), cc.half(), chunk=32)
    with pytest.raises(TypeError):
        sops.ssd(x, dt.to(torch.bfloat16), a, bb, cc, chunk=32)
    with pytest.raises(TypeError):
        sops.ssd(x, dt, a.double(), bb, cc, chunk=32)
    # shared memory, as the kernel library lays it out: 215,168 B on the
    # scalar route for mamba2-2.7b at the mixer's chunk, 214,528 B on the
    # tensor cores (a two-slot ring); chunk 256 is refused on both
    from repro_torch.kernels.ssd_scan import build as sbuild
    lib = sbuild.load()
    assert lib.ssd_smem_bytes(128, 128, 64) == 215_168
    assert lib.ssd_mma_smem_bytes(128, 128, 64) == 214_528
    assert lib.ssd_mma_supported(128, 128, 64) and not lib.ssd_mma_supported(256, 128, 64)
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bb, cc = _ssd_inputs(1, 256, 2, 1, 64, 128, 2, cuda, dtype)
        with pytest.raises(ValueError):
            sops.ssd(x, dt, a, bb, cc, chunk=256)


def _qmm_operands(m, k, n, dev):
    rng = np.random.default_rng(m + k + n)
    xq = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(dev)
    sx = torch.tensor(0.013, device=dev)
    sw = torch.from_numpy(rng.uniform(0.001, 0.1, size=(n,)).astype(np.float32)).to(dev)
    return xq, wq, sx, sw


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (3, 100, 50), (70, 130, 9), (4, 2560, 10576),
                                   (257, 513, 65), (128, 5120, 2560), (2, 1, 3)])
def test_quant_matmul_kernel_matches_plain(cuda, m, k, n):
    """Exact: the int32 core and the epilogue's order are fixed. Row-major
    w_q (copied per call) and the `qmm_weights` layout alike."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref
    xq, wq, sx, sw = _qmm_operands(m, k, n, cuda)
    before = qops.quant_matmul.launches
    got = qops.quant_matmul(xq, wq, sx, sw)
    torch.cuda.synchronize()
    assert qops.quant_matmul.launches == before + 1
    assert torch.equal(got, qref.quant_matmul_ref(xq, wq, sx, sw))
    assert torch.equal(got.cpu(), qops.quant_matmul(xq.cpu(), wq.cpu(), sx.cpu(), sw.cpu()))
    assert torch.equal(got, qops.quant_matmul(xq, qops.qmm_weights(wq), sx, sw))


@pytest.mark.parametrize("m", [1, 4, 16, 63, 64, 65, 2048])
@pytest.mark.parametrize("k,n", [(2560, 1000), (200, 97), (48, 10576)])
def test_quant_matmul_kernel_both_tiles(cuda, m, k, n):
    """M on both sides of the narrow tile's limit (64 x 64 up to M = 64,
    128 x 128 above, each counted), K ragged against the 128-byte K step,
    N ragged against both tile widths."""
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref
    xq, wq, sx, sw = _qmm_operands(m, k, n, cuda)
    launches = qops.quant_matmul.launches, qops.quant_matmul.narrow_launches
    got = qops.quant_matmul(xq, qops.qmm_weights(wq), sx, sw)
    torch.cuda.synchronize()
    narrow = int(m <= qops.NARROW_M)
    assert (qops.quant_matmul.launches, qops.quant_matmul.narrow_launches) == \
        (launches[0] + 1, launches[1] + narrow)
    assert torch.equal(got, qref.quant_matmul_ref(xq, wq, sx, sw))


def test_quant_matmul_kernel_refuses_bad_operands(cuda):
    from repro_torch.kernels.quant_matmul import ops as qops
    xq = torch.ones((4, 64), dtype=torch.int8, device=cuda)
    wq = torch.ones((64, 32), dtype=torch.int8, device=cuda)
    sw = torch.ones(32, device=cuda)
    with pytest.raises(TypeError):
        qops.quant_matmul(xq.int(), wq, 1.0, sw)
    with pytest.raises(TypeError):
        qops.quant_matmul(xq, wq, 1.0, sw.double())
    with pytest.raises(TypeError):
        qops.qmm_weights(wq.int())
    with pytest.raises(ValueError):            # strided activations
        qops.quant_matmul(torch.ones((4, 128), dtype=torch.int8, device=cuda)[:, ::2], wq,
                          1.0, sw)
    # the K-major view of (N, K) is the kernel's own layout, taken as it is
    kmajor = wq.T.contiguous().T
    assert torch.equal(qops.quant_matmul(xq, kmajor, 1.0, sw), qops.quant_matmul(xq, wq, 1.0, sw))
    x = torch.randn(8, 64, device=cuda, dtype=torch.bfloat16)
    y = qops.qlinear(x, wq, sw)
    assert y.dtype == torch.bfloat16 and y.shape == (8, 32)


def test_engine_prefill_launches_ssd_once_per_layer(cuda):
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import api, base
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(configs.smoke("mamba2-2.7b"), n_layers=3)
    params = base.tree_init(api.abstract_params(cfg),
                            torch.Generator(device=cuda).manual_seed(0), cuda)
    prompts = np.arange(2 * 50, dtype=np.int32).reshape(2, 50) % cfg.vocab
    sops.reset_launches()
    out = Engine(cfg, params, ServeConfig(max_len=64, max_new_tokens=4)).generate(prompts)
    assert out.shape == (2, 4)
    assert sops.ssd.launches == cfg.n_layers
    plain = Engine(cfg, params, ServeConfig(max_len=64, max_new_tokens=4),
                   use_kernel=False).generate(prompts)
    assert sops.ssd.launches == cfg.n_layers
    assert out.shape == plain.shape


# -- the prefill causal conv (kernels/causal_conv) ---------------------------

def _conv_view(batch, seq, row, at, conv_dim, dtype, dev, seed):
    """A (batch, seq, conv_dim) view at column `at` of a (batch, seq, row)
    product, as the mixer hands in_proj's x|B|C columns to the kernel, and
    fp32 weights and bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    zx = torch.randn((batch, seq, row), generator=g, device=dev).to(dtype)
    w = torch.randn((4, conv_dim), generator=g, device=dev) / 2
    b = torch.rand((conv_dim,), generator=g, device=dev) - 0.5
    return zx.narrow(-1, at, conv_dim), w, b


# (batch, seq, row, first column, conv_dim, dtype, vector route): mamba2-2.7b's widths
# (row 10,576, columns 5,120-10,495) at the benchmark's largest calls, fp32, S = 1 and 3;
# one rank of four (row 2,836, 1,536 channels), whose bf16 rows (5,672 B) take the
# element route and fp32 rows (11,344 B) the vector route; on the element route also a
# conv_dim off the multiples of 8 and an odd first column
_CONV_CASES = [
    (16, 4096, 10576, 5120, 5376, _BF16, True), (64, 512, 10576, 5120, 5376, _BF16, True),
    (2, 300, 10576, 5120, 5376, _F32, True), (3, 1, 10576, 5120, 5376, _BF16, True),
    (3, 3, 10576, 5120, 5376, _BF16, True), (3, 3, 10576, 5120, 5376, _F32, True),
    (4, 512, 2836, 1280, 1536, _BF16, False), (4, 512, 2836, 1280, 1536, _F32, True),
    (2, 130, 61, 21, 37, _BF16, False), (2, 65, 80, 7, 40, _F32, False)]


@pytest.mark.parametrize("batch,seq,row,at,conv_dim,dtype,vec", _CONV_CASES)
def test_causal_conv_kernel_matches_plain(cuda, batch, seq, row, at, conv_dim, dtype, vec):
    """The kernel on a strided view against the plain version at fp32 (the
    input widened, fp32 weights): bf16 within one bf16 ulp of the larger of
    the two (the kernel rounds its fp32 sum once) plus 1e-6 for the sums'
    order, fp32 within 1e-5 relative; the route the view allows."""
    from repro_torch.kernels.causal_conv import ops as cops
    from repro_torch.kernels.causal_conv import ref as cref
    xbc, w, b = _conv_view(batch, seq, row, at, conv_dim, dtype, cuda, seq + conv_dim)
    before, before_vec = cops.causal_conv.launches, cops.causal_conv.vec_launches
    got = cops.causal_conv(xbc, w, b)
    torch.cuda.synchronize()
    assert (cops.causal_conv.launches, cops.causal_conv.vec_launches) == \
        (before + 1, before_vec + int(vec))
    assert got.dtype == dtype and got.shape == (batch, seq, conv_dim) and got.is_contiguous()
    want = cref.causal_conv(xbc.float(), w, b)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        g = got.float()
        ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), want.abs())
        assert bool(((g - want).abs() <= ulp + 1e-6).all())
    assert torch.equal(got, cops.causal_conv(xbc.contiguous(), w, b))


def test_causal_conv_kernel_refuses_bad_operands(cuda):
    from repro_torch.kernels.causal_conv import ops as cops
    xbc, w, b = _conv_view(2, 8, 64, 0, 64, _BF16, cuda, 1)
    with pytest.raises(TypeError):
        cops.causal_conv(xbc.half(), w, b)
    with pytest.raises(ValueError):                       # channels not packed
        cops.causal_conv(xbc.transpose(1, 2), w[:, :8], b[:8])
    for width in (1, 3, 5):                               # the kernel holds width 4 alone
        with pytest.raises(ValueError):
            cops.causal_conv(xbc, torch.zeros((width, 64), device=cuda), b)
    # a bf16 weight (the serving copy's conv_w) is read as its fp32 values
    got = cops.causal_conv(xbc, w.to(_BF16), b)
    assert torch.equal(got, cops.causal_conv(xbc, w.to(_BF16).float(), b))


def test_mixer_prefill_takes_the_conv_kernel_once_a_layer(cuda):
    """A served mamba2-2.7b prefill (its 64 layers, the smoke widths)
    launches the conv kernel once a layer, each `mixer.conv` span of the
    prefill with `route="kernel"` and decode's without a route; a
    training forward with autograd recording keeps the plain route; a
    prefill under the counting mode launches the kernel too, and counts
    its formula once a layer."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.causal_conv import ops as cops
    from repro_torch.launch import cost
    from repro_torch.models import api, base
    from repro_torch.netgen import telemetry
    from repro_torch.serve.engine import Engine, ServeConfig
    n_layers = configs.get_config("mamba2-2.7b").n_layers
    cfg = dataclasses.replace(configs.smoke("mamba2-2.7b"), n_layers=n_layers)
    params = base.tree_init(api.abstract_params(cfg),
                            torch.Generator(device=cuda).manual_seed(0), cuda)
    prompts = np.arange(2 * 50, dtype=np.int32).reshape(2, 50) % cfg.vocab
    engine = Engine(cfg, params, ServeConfig(max_len=64, max_new_tokens=3))
    cops.reset_launches()
    telemetry.disable()
    telemetry.reset()
    telemetry.enable()
    try:
        out = engine.generate(prompts)
    finally:
        telemetry.disable()
    spans = telemetry.get_registry().spans()
    telemetry.reset()
    assert out.shape == (2, 3) and cops.causal_conv.launches == n_layers == 64
    routes = Counter(s.attrs.get("route") for s in spans if s.name == "mixer.conv")
    assert routes == {"kernel": n_layers, None: 2 * n_layers}
    tokens = torch.as_tensor(prompts, device=cuda).long()
    trained = base.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    logits, _ = api.forward(cfg, trained, {"tokens": tokens})
    logits.float().sum().backward()
    assert cops.causal_conv.launches == n_layers
    assert trained["layers"]["mixer"]["conv_w"].grad is not None
    cache = base.tree_init(api.abstract_cache(cfg, 2, 64), torch.Generator(device=cuda), cuda)
    with torch.inference_mode(), cost.Counter() as counted:
        api.prefill(cfg, params, {"tokens": tokens}, cache, use_kernel=True)
    assert cops.causal_conv.launches == 2 * n_layers
    flops, bytes_ = cops.work(2, 50, cfg.conv_dim, cops.WIDTH, cfg.cdtype().itemsize)
    assert counted.kernels["causal_conv"] == {
        "calls": n_layers, "flops": float(n_layers * flops), "bytes": float(n_layers * bytes_)}


# ---------------------------------------------------------------------------
# The tuner's Hopper grid and the tuned/explored targets on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paper_circuit():
    """A 784-500-10 net with |w| <= 9 (int8 weights, 4 bit-planes), its
    optimized circuit, and 256 images."""
    net = _net(40, (784, 500, 10), lo=-9, hi=9)
    return net, netgen.lower(net), _images(40, 256, 784)


def _launches():
    wrappers = (ops.binary_forward_planes, ops.binary_matmul_planes, ops.binary_matmul,
                ops.binary_matmul_packed, fops.fused_mlp_predict)
    return sum(w.launches for w in wrappers)


@pytest.mark.parametrize("form", ["dense", "packed", "planes", "fusednet"])
def test_every_hopper_grid_tile_launches_at_full_width(cuda, paper_circuit, form):
    """Every tile of the tuner's grid launches its form's kernels at
    784-500-10, and the answers equal `predict_quantized`; every launch of
    the int8-weight net takes a tensor-core route."""
    from repro_torch.netgen.backends import cuda as backend

    net, circuit, x = paper_circuit
    want = quantize.predict_quantized(net, device=cuda)(x)
    for tile in backend._TUNE_BLOCKS:
        flags = {} if form == "dense" else {form: True}
        fn = backend.compile_cuda(circuit, device=cuda, **tile, **flags)
        before = _launches()
        mma = ops.binary_forward_planes.mma_launches + ops.binary_matmul.mma_launches \
            + ops.binary_matmul_packed.mma_launches
        got = fn(x)
        torch.cuda.synchronize()
        assert _launches() - before == fn.launches_per_call > 0, tile
        if form != "planes":
            assert ops.binary_forward_planes.mma_launches + ops.binary_matmul.mma_launches \
                + ops.binary_matmul_packed.mma_launches - mma == fn.launches_per_call, tile
        assert fn.blocks == tile and torch.equal(got, want), tile


def test_tuned_targets_launch_and_answer_on_the_card(cuda, paper_circuit, tmp_path):
    """`cuda[tuned=true]`, `cuda[tuned=true,planes=true]` and
    `fused[tuned=true]` on the card: every measured candidate launches,
    the winners' answers equal `predict_quantized`, and a second session
    over the tune store measures nothing."""
    net, _, x = paper_circuit
    want = quantize.predict_quantized(net, device=cuda)(x)
    targets = ("cuda[tuned=true]", "cuda[tuned=true,planes=true]", "fused[tuned=true]")
    session = netgen.Session(device=cuda, tune_store=tmp_path / "tune")
    for target in targets:
        before = _launches()
        art = session.compile(net, target=target)
        assert _launches() > before, target            # the search ran the kernels
        before = _launches()
        assert torch.equal(art(x), want), target
        assert _launches() - before == art.artifact.launches_per_call, target
    stats = session.tune_stats()
    assert stats.tunes == 3 and stats.measurements >= 14 + 4 + 1
    warm = netgen.Session(device=cuda, tune_store=tmp_path / "tune")
    for target in targets:
        assert torch.equal(warm.compile(net, target=target)(x), want), target
    assert (warm.tune_stats().measurements, warm.tune_stats().tunes) == (0, 0)
    assert "sm_" in netgen.tune.device_kind(cuda)


def test_explored_winner_serves_on_the_card(cuda, paper_circuit, tmp_path):
    net, _, x = paper_circuit
    want = quantize.predict_quantized(net, device=cuda)(x)
    session = netgen.Session(device=cuda, tune_store=tmp_path / "tune")
    rep = session.explore(net, objective="latency", budget=4, seed=0, reps=1,
                          space=netgen.SearchSpace(pipelines=("default",)))
    measured = session.tune_stats().measurements
    art = session.compile(net, target="cuda[explored=true]", pipeline=rep.best.pipeline)
    assert session.tune_stats().measurements == measured
    assert art.artifact.datapath == rep.best.form
    before = _launches()
    assert torch.equal(art(x), want)
    assert _launches() - before == art.artifact.launches_per_call
