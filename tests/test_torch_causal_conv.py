"""The prefill causal conv (`kernels/causal_conv`) on the CPU: the
wrapper's plain version against the composed conv the Mamba2 mixer ran
before the kernel, on the views of in_proj's product the mixer hands it;
its fake on `meta`; the mixer's route and span. The kernel itself is
held to the plain version on the card (`tests/test_torch_cuda.py`)."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels.causal_conv import ops, ref
from repro_torch.layers import mamba2 as m2
from repro_torch.models import api, base, mamba
from repro_torch.netgen import telemetry

W = 4


def _composed(x, b, c, conv_w, conv_b):
    """The mixer's prefill conv as it stood before the kernel: the cat of
    x|B|C, the pad, four shifted products in the input's dtype, the bias,
    SiLU in fp32."""
    dt_ = x.dtype
    S = x.shape[1]
    xbc = torch.cat([x, b, c], dim=-1)
    conv_w = conv_w.to(dt_)
    pads = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pads[:, i:i + S, :] * conv_w[i][None, None, :] for i in range(W))
    conv = conv + conv_b.to(dt_)
    return F.silu(conv.float()).to(dt_), xbc


def _product(batch, seq, row, dtype, seed):
    """A stand-in for in_proj's product (batch, seq, row)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, seq, row), generator=g).to(dtype)


def _leaves(conv_dim, seed):
    g = torch.Generator().manual_seed(seed + 1)
    return (torch.randn((W, conv_dim), generator=g) / 2,
            torch.rand((conv_dim,), generator=g) - 0.5)


# (x width, B|C width, in_proj row, x's first column): mamba2-2.7b (5,120 + 256 channels
# of a 10,576-wide row), a conv_dim off the multiples of 8 (37), an odd first column
WIDTHS = [(5120, 128, 10576, 5120), (21, 8, 61, 21), (24, 16, 80, 7)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq", [1, 2, 3, 4, 127, 128, 300])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("widths", WIDTHS, ids=["mamba2", "ragged", "odd_offset"])
def test_plain_version_equals_the_composed_conv(dtype, seq, batch, widths):
    """The wrapper on CPU tensors, handed the narrow x|B|C view of the
    product, gives the composed conv's bits; the conv state sliced from
    the view equals the one sliced from the cat."""
    di, gn, row, at = widths
    zx = _product(batch, seq, row, dtype, seq + batch)
    conv_dim = di + 2 * gn
    conv_w, conv_b = _leaves(conv_dim, seq)
    xbc = zx.narrow(-1, at, conv_dim)
    x, b, c = torch.split(xbc, [di, gn, gn], dim=-1)
    want, cat = _composed(x, b, c, conv_w, conv_b)
    got = ops.causal_conv(xbc, conv_w, conv_b)
    assert got.dtype == dtype and got.shape == (batch, seq, conv_dim) and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(xbc[:, seq - (W - 1):].float(), cat[:, seq - (W - 1):].float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_composed_conv_on_contiguous_input(dtype):
    xbc = _product(2, 9, 40, dtype, 5)
    conv_w, conv_b = _leaves(40, 5)
    want, _ = _composed(xbc[..., :24], xbc[..., 24:32], xbc[..., 32:], conv_w, conv_b)
    assert torch.equal(ref.causal_conv(xbc, conv_w, conv_b), want)


def test_fake_on_meta_and_bad_operands():
    xbc = torch.empty((2, 7, 40), dtype=torch.bfloat16, device="meta")
    out = ops.causal_conv(xbc, torch.empty((W, 40), device="meta"),
                          torch.empty((40,), device="meta"))
    assert out.device.type == "meta" and out.shape == (2, 7, 40) and out.dtype == torch.bfloat16
    x = torch.zeros((2, 7, 40))
    with pytest.raises(ValueError):
        ops.causal_conv(x, torch.zeros((W, 39)), torch.zeros(40))
    with pytest.raises(ValueError):
        ops.causal_conv(x, torch.zeros((W, 40)), torch.zeros(39))
    with pytest.raises(ValueError):
        ops.causal_conv(x[0], torch.zeros((W, 40)), torch.zeros(40))
    with pytest.raises(ValueError):
        ops.causal_conv(x, torch.zeros((W, 40), device="meta"), torch.zeros(40))


def _mixer(dtype):
    cfg = dataclasses.replace(configs.smoke("mamba2-2.7b"), compute_dtype=dtype)
    params = base.tree_init(api.abstract_params(cfg), torch.Generator().manual_seed(0), "cpu")
    return cfg, mamba.layer(params["layers"], 0)["mixer"]


@pytest.mark.parametrize("grad", [False, True])
def test_mixer_keeps_the_plain_route_on_the_cpu(grad):
    """On the CPU the prefill conv is the composed code (`route="plain"`
    on its span), with autograd recording or not; the launch count stays."""
    cfg, p = _mixer("float32")
    xin = torch.randn((2, 11, cfg.d_model), generator=torch.Generator().manual_seed(2))
    if grad:
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    before = ops.causal_conv.launches
    telemetry.disable()
    telemetry.reset()
    telemetry.enable()
    try:
        with torch.set_grad_enabled(grad):
            out, state = m2.mamba_mixer(cfg, p, xin, return_state=True)
    finally:
        telemetry.disable()
    convs = [s for s in telemetry.get_registry().spans() if s.name == "mixer.conv"]
    telemetry.reset()
    assert [s.attrs for s in convs] == [{"route": "plain"}]
    assert ops.causal_conv.launches == before
    assert state["conv"].shape == (2, W - 1, cfg.conv_dim) and out.shape == xin.shape
    if grad:
        out.sum().backward()
        assert p["conv_w"].grad is not None and p["conv_b"].grad is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counting_records_the_formula_once(device, dtype):
    """Under the counting mode a call of the op records `work`'s formula
    once as kernel "causal_conv", and none of its plain version's ops."""
    from repro_torch.launch import cost
    row = _product(3, 9, 61, dtype, 7).to(device)
    xbc = row.narrow(-1, 5, 40)
    conv_w, conv_b = (t.to(device) for t in _leaves(40, 7))
    with cost.Counter() as c:
        ops.causal_conv(xbc, conv_w, conv_b)
    flops, bytes_ = ops.work(3, 9, 40, W, row.element_size())
    assert c.kernels == {"causal_conv": {"calls": 1, "flops": float(flops),
                                         "bytes": float(bytes_)}}
    assert (c.flops, c.bytes, c.n_ops) == (flops, bytes_, 0)


def test_mixer_on_meta_counts_the_composed_conv():
    """The dry run's mixer on `meta` takes the composed conv: the counter
    reads its aten ops, as before the kernel, and no "causal_conv" call."""
    from repro_torch.launch import cost, dryrun
    cfg = configs.smoke("mamba2-2.7b")
    p = mamba.layer(dryrun.tree_sds(api.abstract_params(cfg))["layers"], 0)["mixer"]
    xin = torch.empty((2, 11, cfg.d_model), dtype=cfg.cdtype(), device="meta")
    with torch.inference_mode(), cost.Counter() as c:
        out = m2.mamba_mixer(cfg, p, xin)
    assert out.device.type == "meta" and out.shape == xin.shape
    assert "causal_conv" not in c.kernels and c.n_ops > 0


def test_counted_prefill_through_the_op_is_meta_plus_the_conv_swap(monkeypatch):
    """A prefill whose conv goes through the op (the card's route; here the
    op's plain version) counts what `meta`'s composed conv counts, plus
    `chip_smoke._conv_count_swap`: each layer's formula in place of the
    cat and the composed ops. The card's roofline check rests on this."""
    import importlib.util
    from pathlib import Path
    from repro_torch.launch import dryrun
    from repro_torch.models.base import ShapeConfig
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = configs.smoke("mamba2-2.7b")
    shape = ShapeConfig("chip", 64, 2, "prefill")
    meta = dryrun.count_step(dryrun.build_step(cfg, shape, device="meta"))
    monkeypatch.setattr(m2, "_conv_on_card", lambda x, p: True)
    routed = dryrun.count_step(dryrun.build_step(cfg, shape, device="cpu"))
    flops, bytes_ = smoke._conv_count_swap(cfg, 2, 64)
    assert routed.kernels["causal_conv"]["calls"] == cfg.n_layers
    assert (routed.flops, routed.bytes) == (meta.flops + flops, meta.bytes + bytes_)
    assert bytes_ < 0 < flops
