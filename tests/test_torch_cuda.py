"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: every test skips without a CUDA device (the check runs in
a fixture, not at import). On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed. Every comparison is exact: the paths are integer.
"""
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
    assert torch.equal(got.long(), want)


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


def test_noncontiguous_operands_raise(cuda):
    rng = np.random.default_rng(2)
    x = _words(rng, (8, 6), cuda)
    pos = _words(rng, (2, 6, 64), cuda)
    with pytest.raises(ValueError):
        ops.binary_matmul_planes(x, pos[..., ::2], pos[..., ::2])


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
    assert torch.equal(ops.binary_matmul(x, w), want)
    assert torch.equal(ops.binary_matmul_packed(ops.pack_bits(x), w), want)


@pytest.mark.parametrize("b,k,h,o,bm,thr", [
    (256, 784, 500, 10, None, 128), (37, 784, 500, 10, 1, 0), (9, 45, 21, 7, 8, 254),
    (100, 70, 1100, 12, 32, 100), (3, 33, 40, 1, 4, 128), (64, 1000, 64, 30, 16, 50)])
def test_fused_kernel_matches_plain(cuda, b, k, h, o, bm, thr):
    """The paper shape at the default block, H wider than the block's
    threads, one class, and K and H ragged."""
    rng = np.random.default_rng(b + k + h)
    x = torch.from_numpy(_images(b, b, k)).to(cuda)
    w1 = torch.from_numpy(rng.integers(-9, 10, size=(k, h)).astype(np.int32)).to(cuda)
    w2 = torch.from_numpy(rng.integers(-9, 10, size=(h, o)).astype(np.int32)).to(cuda)
    before = fops.fused_mlp_predict.launches
    got = fops.fused_mlp_predict(x, w1, w2, threshold=thr, bm=bm)
    torch.cuda.synchronize()
    assert fops.fused_mlp_predict.launches == before + 1
    assert torch.equal(got, fref.fused_mlp_predict(x, w1, w2, threshold=thr))


def test_fused_kernel_all_scores_negative(cuda):
    rng = np.random.default_rng(4)
    w1 = torch.from_numpy(rng.integers(-9, 10, size=(40, 16)).astype(np.int32)).to(cuda)
    w2 = torch.from_numpy(-rng.integers(1, 6, size=(16, 6)).astype(np.int32)).to(cuda)
    x = _images(3, 9, 40)
    x[:, :8] = 255
    x = torch.from_numpy(x).to(cuda)
    got = fops.fused_mlp_predict(x, w1, w2, threshold=128)
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
    wrapper.launches = 0
    x = _images(4, 150, 120)
    out = server.predict_many({"v0": x, "v1": x[:70], "v2": x[:9]})
    single = server.predict("v1", x)
    assert wrapper.launches > 0
    for name, req in (("v0", x), ("v1", x[:70]), ("v2", x[:9])):
        want = quantize.predict_quantized(nets[name], device=cuda)(req)
        np.testing.assert_array_equal(out[name], want.cpu().numpy())
    np.testing.assert_array_equal(
        single, quantize.predict_quantized(nets["v1"], device=cuda)(x).cpu().numpy())
