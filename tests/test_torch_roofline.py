"""The port's roofline (`repro_torch.launch.roofline`) and counting mode
(`repro_torch.launch.cost`) on the CPU, held to the reference's
`repro.launch.roofline`.

* `model_flops`, `active_param_count` and the three inner-scan
  corrections equal the reference's, as floats, for every config and
  every shape of `SHAPES` (the 32 cells of `all_cells()` among them);
  `Q_BLK`/`K_BLK` are the port's flash defaults, `SSD_CHUNK` its
  mixer's; the bottleneck and fraction logic of `test_dryrun_small.py`
  on the port's `HW`.
* The counter sees every layer: for each family (dense, moe, ssm,
  hybrid) at the smoke width, a prefill's, a decode step's and a train
  step's FLOPs, bytes and argument bytes at n_layers L1, L2 (the dry run's
  `analysis_layers`) and the full config's count lie on one line a + L b,
  with no residual; so do a 2048-token (flash attention) prefill's and
  train step's at L1, L2 and 3 L2: what lets `dryrun.analyze_cell`
  extend two counts.
* The count does not depend on the device: a smoke prefill and train
  step counted on CPU tensors equal the same step on `meta`.
* The hand-written kernels are counted once, by formula: `ssd` (B7) as
  the reference's `ssd_correction`, `qlinear` through `quant_matmul`
  (B6) as 2MKN + 2MN, whether the plain version ran (CPU) or the fake
  (`meta`); the plain version's own einsums are not counted again.
* Flash attention at S >= FLASH_MIN_SEQ, counted on `meta`: its forward
  FLOPs equal `flash_correction`'s 4U, forward and backward 18U (the
  port computes every block pair, as the reference does).
* The collective counter on a fake group of 4 ranks: known all-reduce,
  all-gather, reduce-scatter and all-to-all shapes give exact output
  bytes by kind and `_num_ops`, as `test_collective_parser` holds the
  reference's HLO parser.
"""
import dataclasses
import inspect

import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch import roofline as jrl
from repro.models import base as jbase
from repro_torch import configs
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import cost, dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HW
from repro_torch.layers import flash, mamba2
from repro_torch.layers.attention import FLASH_MIN_SEQ
from repro_torch.models import runtime
from repro_torch.models.base import SHAPES, ShapeConfig

PAIRS = [(a, s) for a in configs.ARCHS for s in SHAPES]
FAMILIES = {"dense": "llama3.2-3b", "moe": "granite-moe-1b-a400m", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-2.7b"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_cell_is_among_the_pairs():
    cells = {(c.name, s.name) for c, s in configs.all_cells()}
    assert len(cells) == 32 and cells <= set(PAIRS)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_and_active_params_equal_the_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert rl.active_param_count(cfg) == jrl.active_param_count(jcfg)
    assert rl.model_flops(cfg, SHAPES[shape]) == jrl.model_flops(jcfg, jbase.SHAPES[shape])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_inner_scan_corrections_equal_the_reference(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    s = SHAPES[shape]
    batch = s.global_batch // s.accum if s.kind == "train" else s.global_batch
    kw = dict(batch=batch, seq=s.seq_len, kind=s.kind)
    for name in ("flash_correction", "ssd_correction", "inner_scan_corrections"):
        assert getattr(rl, name)(cfg, **kw) == getattr(jrl, name)(jcfg, **kw), name


def test_flash_blocks_are_the_port_flash_defaults():
    p = inspect.signature(flash.flash_attention).parameters
    assert (rl.Q_BLK, rl.K_BLK) == (p["q_blk"].default, p["k_blk"].default)


def test_ssd_chunk_is_the_port_mixer_default():
    assert rl.SSD_CHUNK == inspect.signature(mamba2.mamba_mixer).parameters["chunk"].default


def test_roofline_bottleneck_logic():
    r = rl.Roofline(
        arch="a", shape="s", mesh="m", chips=256,
        flops_per_device=HW["peak_bf16_flops"],       # exactly 1s of compute
        bytes_per_device=HW["hbm_bw"] * 0.5,          # 0.5s of memory
        collective_bytes=HW["nvlink_bw"] * 0.25,      # 0.25s of collective
        collective_breakdown={}, model_flops=HW["peak_bf16_flops"] * 256 * 0.7,
        peak_mem_per_device=1e9)
    assert r.bottleneck == "compute"
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9 and abs(r.t_collective - 0.25) < 1e-9
    assert abs(r.roofline_fraction - 0.7) < 1e-6
    assert abs(r.useful_flops_ratio - 0.7) < 1e-9
    r2 = dataclasses.replace(r, collective_bytes=HW["nvlink_bw"] * 2.0)
    assert r2.bottleneck == "collective" and abs(r2.roofline_fraction - 0.35) < 1e-6


def test_unrolled_scans_is_a_flag_and_scan_kwargs_is_empty():
    assert not runtime.unrolling() and runtime.scan_kwargs() == {}
    with runtime.unrolled_scans():
        assert runtime.unrolling() and runtime.scan_kwargs() == {}
    assert not runtime.unrolling()


# -- the counter sees every layer --------------------------------------------

def _count(cfg, shape, device="meta"):
    c = dryrun.count_step(dryrun.build_step(cfg, shape, remat="full", device=device))
    return int(c.flops), int(c.bytes), c.arg_bytes


STEPS = {"prefill": ShapeConfig("p", 256, 2, "prefill"),
         "decode": ShapeConfig("d", 256, 2, "decode"),
         "train": ShapeConfig("t", 128, 4, "train", accum=2),
         "flash_prefill": ShapeConfig("fp", FLASH_MIN_SEQ, 1, "prefill"),
         "flash_train": ShapeConfig("ft", FLASH_MIN_SEQ, 1, "train")}


LINEAR = [(f, k) for f in FAMILIES for k in STEPS
          if not (k.startswith("flash") and f == "ssm")]      # no attention


@pytest.mark.parametrize("family,kind", LINEAR)
def test_counts_are_linear_in_the_layer_count(family, kind):
    arch = FAMILIES[family]
    smoke = configs.smoke(arch)
    L1, L2 = dryrun.analysis_layers(smoke)
    full = 3 * L2 if kind.startswith("flash") else configs.get_config(arch).n_layers
    Ls = (L1, L2, full)
    counts = [_count(dataclasses.replace(smoke, n_layers=L), STEPS[kind]) for L in Ls]
    for c1, c2, c3 in zip(*counts):
        assert c2 > c1
        assert (c2 - c1) * (Ls[2] - Ls[0]) == (c3 - c1) * (Ls[1] - Ls[0]), (Ls, c1, c2, c3)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_counts_do_not_depend_on_the_device(family, kind):
    cfg = configs.smoke(FAMILIES[family])
    shape = dataclasses.replace(STEPS[kind], seq_len=128)
    assert _count(cfg, shape, "cpu")[:2] == _count(cfg, shape, "meta")[:2]


# -- the kernels, counted once ------------------------------------------------

def _ssd_inputs(device, B=2, L=256, H=4, P=16, G=1, N=16):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, L, H, P, generator=g)
    dt = torch.rand(B, L, H, generator=g) * 0.1
    a = -torch.rand(H, generator=g)
    b = torch.randn(B, L, G, N, generator=g)
    c = torch.randn(B, L, G, N, generator=g)
    return [t.to(device) for t in (x, dt, a, b, c)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ssd_is_counted_once_by_formula(device):
    x, dt, a, b, c = _ssd_inputs(device)
    with cost.Counter() as counter:
        y, s = ssd_ops.ssd(x, dt, a, b, c, chunk=128)
    assert (y.shape, y.dtype, s.shape, s.dtype) == (x.shape, x.dtype, (2, 4, 16, 16),
                                                    torch.float32)
    flops, bytes_ = rl.ssd_forward(2, 256, 4, 16, 16, 1, 128)
    assert (counter.flops, counter.bytes) == (flops, bytes_)
    assert counter.kernels == {"ssd_scan": {"calls": 1, "flops": flops, "bytes": bytes_}}
    with cost.Counter() as plain:                      # the plain version alone
        ssd_ref.ssd(x, dt, a, b, c, chunk=128)
    assert plain.flops > 0 and plain.kernels == {}


def test_mamba2_prefill_counts_the_ssd_as_ssd_correction():
    cfg = configs.smoke("mamba2-2.7b")
    shape = ShapeConfig("p", 256, 2, "prefill")
    c = dryrun.count_step(dryrun.build_step(cfg, shape, device="cpu"))
    want = rl.ssd_correction(cfg, batch=2, seq=256, kind="prefill")
    assert c.kernels["ssd_scan"]["calls"] == cfg.n_layers
    assert c.kernels["ssd_scan"]["flops"] == want["flops"]
    assert c.kernels["ssd_scan"]["bytes"] == want["bytes"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_qlinear_counts_quant_matmul_once_by_formula(device):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 40, generator=g).to(device)
    w_q = torch.randint(-127, 128, (40, 24), dtype=torch.int8, generator=g).to(device)
    sw = torch.rand(24, generator=g).to(device)
    with cost.Counter() as counter:
        y = qops.qlinear(x, w_q, sw)
    assert y.shape == (6, 24) and y.dtype == x.dtype and y.device.type == device
    ops, bytes_ = qops.work(6, 40, 24)
    assert ops == 2 * 6 * 40 * 24 + 2 * 6 * 24
    assert counter.kernels == {"quant_matmul": {"calls": 1, "flops": ops, "bytes": bytes_}}
    assert counter.flops == ops                   # quantize_act does no matmul


def test_kernel_wrappers_without_a_counter_count_nothing():
    x, dt, a, b, c = _ssd_inputs("meta")
    assert cost.active() == []
    y, _ = ssd_ops.ssd(x, dt, a, b, c, chunk=128)
    assert y.is_meta


def test_nested_counters_both_record():
    x, dt, a, b, c = _ssd_inputs("meta")
    with cost.Counter() as outer:
        with cost.Counter() as inner:
            ssd_ops.ssd(x, dt, a, b, c, chunk=128)
        torch.empty(3, device="meta").add_(1)
    assert inner.flops == outer.flops > 0
    assert outer.bytes == inner.bytes + 2 * 3 * 4


# -- flash attention ----------------------------------------------------------

def _flash_cfg():
    return dataclasses.replace(configs.smoke("llama3.2-3b"), n_layers=1, n_kv_heads=2)


def test_flash_forward_flops_equal_flash_correction():
    cfg = _flash_cfg()
    B, S = 1, FLASH_MIN_SEQ
    q = torch.empty(B, cfg.n_heads, S, cfg.head_dim, device="meta", dtype=torch.bfloat16)
    k = torch.empty(B, cfg.n_kv_heads, S, cfg.head_dim, device="meta", dtype=torch.bfloat16)
    with cost.Counter() as c:
        flash.flash_attention(q, k, k.clone())
    assert c.flops == rl.flash_correction(cfg, batch=B, seq=S, kind="prefill")["flops"]


def test_flash_forward_and_backward_flops_are_18u():
    cfg = _flash_cfg()
    B, S, H, hd = 1, FLASH_MIN_SEQ, cfg.n_heads, cfg.head_dim
    U = B * H * S * S * hd
    q = torch.empty(B, H, S, hd, device="meta", requires_grad=True)
    k = torch.empty(B, cfg.n_kv_heads, S, hd, device="meta", requires_grad=True)
    v = torch.empty(B, cfg.n_kv_heads, S, hd, device="meta", requires_grad=True)
    with cost.Counter() as c:
        out = flash.flash_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    # the reference's train figure adds the remat recompute of the forward
    train = rl.flash_correction(cfg, batch=B, seq=S, kind="train")["flops"]
    assert c.flops == 18 * U == train - 4 * U


# -- collectives on a fake group ----------------------------------------------

@pytest.fixture
def fake_world():
    assert not dist.is_initialized()
    dryrun.open_fake_world(4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collective_counter(fake_world):
    x = torch.empty(16, 128, device="meta")
    with cost.Counter() as c:
        dist.all_reduce(x)
        parts = [torch.empty(2, 8, dtype=torch.bfloat16, device="meta") for _ in range(4)]
        dist.all_gather(parts, torch.empty(2, 8, dtype=torch.bfloat16, device="meta"))
        dist.reduce_scatter_tensor(torch.empty(8, dtype=torch.bfloat16, device="meta"),
                                   torch.empty(32, dtype=torch.bfloat16, device="meta"))
        dist.all_to_all_single(torch.empty(64, device="meta"), torch.empty(64, device="meta"))
        torch.empty(2, 2, device="meta").add_(1)       # no collective
    st = rl.collective_stats(c.collective_ops)
    assert st == {"all-reduce": 16 * 128 * 4, "all-gather": 4 * 2 * 8 * 2,
                  "reduce-scatter": 8 * 2, "all-to-all": 64 * 4, "_num_ops": 4}
    assert c.summary()["coll"] == sum(v for k, v in st.items() if k != "_num_ops")


def test_collective_stats_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        rl.collective_stats([("broadcast", 4)])
