"""Parity of the port's SSD scan (`repro_torch.kernels.ssd_scan`) with the
JAX package's, on the CPU.

The same seeded numpy inputs go to both sides: the port's wrapper takes
its plain PyTorch version for CPU tensors; the JAX op runs its Pallas
kernel in the package's default interpret mode. Tolerances are those of
`tests/test_kernels_ssd.py`: 2e-4 in fp32 (two orders of summation of
the same fp32 chunked algorithm), 5e-2 in bf16 (y rounded to bf16).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro_torch.kernels.ssd_scan import ops, ref

SHAPES = [(1, 64, 1, 1, 16, 32, 16), (2, 128, 4, 2, 32, 64, 64),
          (1, 256, 2, 1, 64, 128, 64), (2, 64, 8, 8, 16, 16, 32)]


def _inputs(b, l, h, g, p, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(dtype)
    dt = rng.uniform(0.001, 0.1, size=(b, l, h)).astype(dtype)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    bb = rng.normal(size=(b, l, g, n)).astype(dtype) / np.sqrt(n)
    cc = rng.normal(size=(b, l, g, n)).astype(dtype) / np.sqrt(n)
    return x, dt, a, bb, cc


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_single_head_refs_match_jax():
    x, dt, a, b, c = _inputs(1, 128, 1, 1, 16, 32, seed=0)
    args = (x[0, :, 0], dt[0, :, 0], float(a[0]), b[0, :, 0], c[0, :, 0])
    jargs = [jnp.asarray(v) if isinstance(v, np.ndarray) else v for v in args]
    targs = [torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in args]
    s0 = np.random.default_rng(1).normal(size=(32, 16)).astype(np.float32)
    for fn, jfn, kw in ((ref.ssd_sequential_ref, jref.ssd_sequential_ref, {}),
                        (ref.ssd_chunked_ref, jref.ssd_chunked_ref, {"chunk": 32})):
        for s_init in (None, s0):
            y, s = fn(*targs, s_init=None if s_init is None else torch.from_numpy(s_init), **kw)
            yj, sj = jfn(*jargs, s_init=None if s_init is None else jnp.asarray(s_init), **kw)
            _close(y.numpy(), yj, 2e-5)
            _close(s.numpy(), sj, 2e-5)
    # the chunk decomposition is exact against the recurrence
    y1, s1 = ref.ssd_sequential_ref(*targs)
    y2, s2 = ref.ssd_chunked_ref(*targs, chunk=32)
    _close(y1.numpy(), y2.numpy(), 2e-5)
    _close(s1.numpy(), s2.numpy(), 2e-5)


def test_batched_ref_matches_jax():
    x, dt, a, b, c = _inputs(2, 64, 4, 2, 8, 16, seed=3)
    y, s = ref.ssd_batched_ref(*_t(x, dt, a, b, c), chunk=32)
    yj, sj = jref.ssd_batched_ref(*map(jnp.asarray, (x, dt, a, b, c)), chunk=32)
    _close(y.numpy(), yj, 2e-5)
    _close(s.numpy(), sj, 2e-5)


@pytest.mark.parametrize("b,l,h,g,p,n,chunk", SHAPES)
def test_ssd_matches_pallas(b, l, h, g, p, n, chunk):
    x, dt, a, bb, cc = _inputs(b, l, h, g, p, n, seed=l + h)
    y, s = ops.ssd(*_t(x, dt, a, bb, cc), chunk=chunk)
    yj, sj = jops.ssd(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=chunk)
    assert y.shape == (b, l, h, p) and s.shape == (b, h, n, p)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y.numpy(), yj, 2e-4)
    _close(s.numpy(), sj, 2e-4)
    yb, sb = ref.ssd_batched_ref(*_t(x, dt, a, bb, cc), chunk=chunk)
    _close(y.numpy(), yb.numpy(), 2e-4)
    _close(s.numpy(), sb.numpy(), 2e-4)


def test_ssd_bf16_matches_pallas():
    x, dt, a, bb, cc = _inputs(1, 64, 2, 1, 16, 32, seed=9)
    jx = [jnp.asarray(v, jnp.bfloat16) for v in (x, dt, bb, cc)]
    tx = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, dt, bb, cc)]
    y, s = ops.ssd(tx[0], tx[1], torch.from_numpy(a), tx[2], tx[3], chunk=32)
    yj, sj = jops.ssd(jx[0], jx[1], jnp.asarray(a), jx[2], jx[3], chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(y.float().numpy(), yj, 5e-2)
    _close(s.numpy(), sj, 5e-2)


def test_chunk_must_divide_length():
    x, dt, a, bb, cc = _inputs(1, 48, 1, 1, 8, 16, seed=2)
    with pytest.raises(AssertionError):
        ops.ssd(*_t(x, dt, a, bb, cc), chunk=32)
    with pytest.raises(AssertionError):
        jops.ssd(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=32)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    x, dt, a, bb, cc = _inputs(2, 64, 4, 2, 8, 16, seed=5)
    ops.reset_launches()
    y, s = ops.ssd(*_t(x, dt, a, bb, cc), chunk=16)
    yp, sp = ref.ssd(*_t(x, dt, a, bb, cc), chunk=16)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    assert ops.ssd.launches == 0


def test_rejects_shapes():
    """Shape errors raise on the CPU too; a chunk too large for the kernel's
    shared memory is refused on the card (tests/test_torch_cuda.py)."""
    x, dt, a, bb, cc = _t(*_inputs(1, 64, 4, 2, 8, 16, seed=6))
    with pytest.raises(ValueError):                  # heads not a multiple of groups
        ops.ssd(x, dt, a, bb[:, :, :1].repeat(1, 1, 3, 1), cc[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(ValueError):                  # dt and x disagree
        ops.ssd(x, dt[:, :, :2], a, bb, cc)
    with pytest.raises(ValueError):                  # b and c disagree
        ops.ssd(x, dt, a, bb, cc[:, :, :1])


def _chip_smoke():
    """`chip_smoke.py`, for its `_ssd_agrees`: the card's bound on the kernel."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split_model(x, dt, a, b, c, *, chunk, split=True):
    """A float32 model of the tensor-core kernel's arithmetic (`ssd_mma_kernel`,
    G = 1): B, C and x enter the products as the bf16 values they are, and
    each fp32 operand (S = CB o L o dt, the carried state s, w o x) as a
    bf16 hi + lo pair (`split=False`: the hi half alone); products and sums
    in fp32, y rounded to bf16 once."""
    def parts(t):
        hi = _bf16(t)
        return (hi, _bf16(t - hi)) if split else (hi,)

    bsz, length, heads, p = x.shape
    n = b.shape[-1]
    xf = x.float().permute(0, 2, 1, 3)                      # (B, H, L, P)
    dtf = dt.float().permute(0, 2, 1)                       # (B, H, L)
    bf, cf = b.float()[:, None, :, 0], c.float()[:, None, :, 0]   # (B, 1, L, N)
    s = torch.zeros((bsz, heads, n, p))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ys = []
    for q0 in range(0, length, chunk):
        xq, dq = xf[:, :, q0:q0 + chunk], dtf[:, :, q0:q0 + chunk]
        bq, cq = bf[:, :, q0:q0 + chunk], cf[:, :, q0:q0 + chunk]
        cum = torch.cumsum(dq * a[None, :, None], dim=-1)
        cb = cq @ bq.transpose(-1, -2)                     # once per group
        decay = torch.exp(cum[..., :, None] - cum[..., None, :])
        smat = torch.where(tri, cb * decay * dq[..., None, :], torch.zeros(()))
        y = torch.exp(cum)[..., None] * sum(cq @ part for part in parts(s))
        y = y + sum(part @ xq for part in parts(smat))
        ys.append(y)
        w = dq * torch.exp(cum[..., -1:] - cum)
        s = torch.exp(cum[..., -1])[..., None, None] * s + sum(
            bq.transpose(-1, -2) @ part for part in parts(w[..., None] * xq))
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(torch.bfloat16)
    return y, s


def test_kernel_split_rounding_meets_the_card_bound():
    """The bf16 hi + lo split that the tensor-core kernel applies to its
    fp32 operands keeps y within one bf16 ulp (+1e-5) and the state within
    1e-4 of the plain version (`chip_smoke._ssd_agrees`, unchanged), at
    mamba2-2.7b's N, P and chunk on 4 heads; the hi half alone (one bf16
    rounding, 2^-9) leaves that bound."""
    x, dt, a, bb, cc = _inputs(1, 256, 4, 1, 64, 128, seed=16)
    x, dt, bb, cc = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, dt, bb, cc))
    a = torch.from_numpy(a)
    yp, sp = ref.ssd(x, dt, a, bb, cc, chunk=128)
    y, s = _split_model(x, dt, a, bb, cc, chunk=128)
    agrees = _chip_smoke()._ssd_agrees
    assert agrees(y, s, yp, sp)
    assert (s - sp).abs().max().item() < 1e-5
    y1, s1 = _split_model(x, dt, a, bb, cc, chunk=128, split=False)
    assert not agrees(y1, s1, yp, sp)
