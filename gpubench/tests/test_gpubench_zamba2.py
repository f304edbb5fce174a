"""The cell `zamba2-7b-instruct.long_prompt`: its files as the harness
finds them, a tiny run of it on the CPU, its reference's count of work,
and the two `program_span` readers it adds (`shared_block_share`,
`shared_attn_roofline`) on span trees built by hand.

The tiny run cuts the configuration to the port's `configs.smoke` sizes
(Zamba2's layout kept: 2 groups, 2 blocks at 3 sites, adapters) and
drives the set-up, the window, the traced cycle, the readers and the
check against `reference/zamba2.py`, as `test_gpubench_harness.py` does
for the mamba2 cells.
"""
import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from gpubench import core
from gpubench.reference import zamba2 as ref

ROOT = Path(__file__).resolve().parents[2]
CELL = "zamba2-7b-instruct.long_prompt"
NEW = ("shared_block_share", "shared_attn_roofline")


def _config() -> dict:
    return json.loads((ROOT / "gpubench/configs/zamba2-7b-instruct.json").read_text())


def _reader(name: str):
    return core.load_module(ROOT / "gpubench" / "metrics" / f"{name}.py").read


def test_the_cell_its_configuration_and_metrics_are_in_the_manifest():
    m = core.load_manifest()
    (cell,) = [w for w in m["workloads"] if w["name"] == CELL]
    assert cell == {"name": CELL, "config": "zamba2-7b-instruct", "traffic": "long_doc",
                    "chips": 1, "why": cell["why"]}
    (conf,) = [c for c in m["configs"] if c["name"] == "zamba2-7b-instruct"]
    assert conf["reduced"] == [] and conf["source"] == _config()["source"]
    for name in NEW:
        (x,) = [x for x in m["per_layer"] if x["name"] == name]
        assert x["workloads"] == [CELL] and x["moves"] == "ttft_p95_ms" and x["unit"] == "%"
    ctx = core.context(m, CELL, 1, 1.0, False, torch.device("cpu"), time.time())
    assert ctx.reference.__name__ == "gpubench_reference_zamba2"
    assert callable(ctx.reference.logits) and callable(ctx.reference.prefill_flops)
    assert ctx.traffic == {"loop": "closed", "clients": 1, "rows": 8,
                           "prompt_lengths": [1024, 2048, 3072, 4092], "new_tokens": 4,
                           "check_requests": 16}
    assert max(ctx.traffic["prompt_lengths"]) + ctx.traffic["new_tokens"] == \
        ctx.config["context_length"] == ctx.config["max_position_embeddings"]


def test_arch_is_the_published_configuration_uncut():
    c = _config()
    a = c["arch"]
    assert c["reduced"] == []
    assert (a["n_layers"], a["d_model"], a["vocab"], a["d_ff"]) == \
        (c["num_hidden_layers"], c["hidden_size"], c["vocab_size"], c["intermediate_size"])
    assert (a["n_heads"], a["n_kv_heads"], a["head_dim"]) == \
        (c["num_attention_heads"], c["num_key_value_heads"], c["attention_head_dim"])
    assert a["n_heads"] * a["head_dim"] == c["attention_hidden_size"] == 2 * a["d_model"]
    assert (a["ssm_state"], a["ssm_groups"], a["ssm_headdim"], a["ssm_expand"],
            a["conv_width"]) == (c["mamba_d_state"], c["mamba_ngroups"], c["mamba_headdim"],
                                 c["mamba_expand"], c["mamba_d_conv"])
    assert a["ssm_expand"] * a["d_model"] // a["ssm_headdim"] == c["n_mamba_heads"]
    assert a["hybrid_layer_ids"] == c["hybrid_layer_ids"] == \
        [i for i, t in enumerate(c["layers_block_type"]) if t == "hybrid"]
    assert (a["num_mem_blocks"], a["adapter_rank"], a["rope_theta"], a["norm_eps"]) == \
        (c["num_mem_blocks"], c["adapter_rank"], c["rope_theta"], c["rms_norm_eps"])
    assert c["use_shared_mlp_adapter"] and not c["use_shared_attention_adapter"]
    assert a["ssm_group_norm"] and a["tie_embeddings"] and c["use_mem_rope"]


def test_prefill_flops_counts_every_weight_a_token_passes_and_the_causal_core():
    from gpubench import counts
    a = _config()["arch"]
    ssd = 81 * counts.ssd_forward(1, 1, 112, 64, 64, 2)[0]
    one = ref.prefill_flops(a, 1, 1) - ssd
    # per token: 81 mixers' 78.4 M matrix weights, 13 sites' 351 M, the head
    assert one == pytest.approx(2 * (81 * 78.4e6 + 13 * 351e6) + 2 * 3584 * 32000, rel=2e-3)
    at = ref.prefill_flops(a, 8, 4092)
    core_flops = 13 * 4.0 * 8 * 32 * 224 * 4092 * 4093 / 2
    assert at > 8 * 4092 * (one - 2 * 3584 * 32000) + core_flops


def test_reference_refuses_a_layout_it_does_not_compute():
    arch = dict(_config()["arch"], hybrid_layer_ids=[])
    with pytest.raises(ValueError, match="published hybrid layout"):
        ref.logits(arch, {}, torch.zeros(1, 4, dtype=torch.long), 1)


def _tiny_ctx(trace: bool) -> core.Context:
    from repro_torch import configs
    manifest = core.load_manifest()
    ctx = core.context(manifest, CELL, 2 ** 31 + 11, 0.2, trace, torch.device("cpu"),
                       time.time())
    small = dataclasses.replace(configs.smoke("zamba2-7b-instruct"), tie_embeddings=True)
    arch = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(small).items()}
    traffic = {"loop": "closed", "clients": 1, "rows": 2, "prompt_lengths": [24, 40],
               "new_tokens": 3, "check_requests": 4}
    return dataclasses.replace(ctx, config=dict(ctx.config, arch=arch), traffic=traffic)


def test_tiny_traced_run_is_correct_and_its_device_readers_say_nothing_on_the_cpu():
    """The cell's own init rules, limits, driver and reference at smoke
    sizes: correct, and the new readers (device seconds) leave the line."""
    manifest = core.load_manifest()
    run, metrics = core.execute(manifest, _tiny_ctx(trace=True))
    assert run.correct and run.failed == 0 and run.attempted % 2 == 0
    value, limit = run.checks["gap"]
    assert 0 <= value <= limit and run.checks["weights_changed"] == (0, 0)
    assert run.trace is not None and not set(NEW) & set(metrics)


# -- the readers on span trees built by hand --------------------------------------------

class _Tree:
    def __init__(self):
        self.records = []

    def add(self, name, parent=None, device=None, **attrs):
        from repro_torch.netgen.telemetry import SpanRecord
        sid = len(self.records) + 1
        rec = SpanRecord(trace_id=parent.trace_id if parent else sid, span_id=sid,
                         parent_id=parent.span_id if parent else None, name=name,
                         start_unix=1.0, duration_s=0.0, attrs=attrs, thread="main",
                         device_time=device)
        self.records.append(rec)
        return rec


@pytest.fixture
def tree(monkeypatch):
    from repro_torch.netgen import telemetry
    t = _Tree()
    monkeypatch.setattr(telemetry, "get_registry",
                        lambda: type("R", (), {"spans": lambda self: list(t.records)})())
    return t


def _run():
    ctx = core.Context(cell={"name": CELL}, config={"arch": _config()["arch"]}, traffic={},
                       limits={}, reference=None, seed=1, seconds=1.0, trace=True,
                       device=torch.device("cpu"), t_start=time.time())
    return core.Run(ctx)


ATTN = dict(route="flash", rows=8, q_len=4092, kv_len=4092, heads=32, kv_heads=32,
            head_dim=224, pairs=32, causal_pairs=20)


def _call(t, prefill=10.0, blocks=(1.0, 2.0), cores=(0.25, 0.5), decode_core=True):
    """A `serve.generate` tree: a prefill with one layer and a shared block
    a site, each with an `attn.core`; a decode step with its own."""
    root = t.add("serve.generate", rows=8, length=4092, new=4)
    pre = t.add("serve.prefill", root, device=prefill)
    t.add("model.layer", pre, device=0.5)
    for s, (b, c) in enumerate(zip(blocks, cores)):
        blk = t.add("zamba.shared_block", pre, device=b, site=s, block=s % 2)
        t.add("attn.core", blk, device=c, **ATTN)
    if decode_core:
        step = t.add("serve.decode_step", root, step=0)
        blk = t.add("zamba.shared_block", step, site=0, block=0)
        t.add("attn.core", blk, **dict(ATTN, route="decode", q_len=1, pairs=1, causal_pairs=1))
    return root


@pytest.mark.parametrize("name", NEW)
def test_new_readers_say_nothing_without_their_spans(tree, name):
    assert _reader(name)(_run()) is None
    root = tree.add("serve.generate", rows=16, length=1024, new=4)   # a mamba2 prefill
    pre = tree.add("serve.prefill", root, device=3.0)
    tree.add("model.layer", pre, device=2.9)
    assert _reader(name)(_run()) is None


def test_shared_block_share_is_the_blocks_device_time_over_the_prefills(tree):
    _call(tree)
    _call(tree, prefill=30.0, blocks=(3.0, 4.0))
    assert _reader("shared_block_share")(_run()) == pytest.approx(100 * 10.0 / 40.0)


def test_shared_attn_roofline_is_the_bound_over_the_prefill_cores(tree):
    from gpubench.metrics.shared_attn_roofline import attn_bound_s
    _call(tree)
    _call(tree, cores=(1.0, 2.0))
    bound = attn_bound_s(ATTN)
    # 4 · 8 · 32 · 224 · 4092 · 4093 / 2 operations at 989 TFLOP/s: the core is compute-bound
    assert bound == pytest.approx(4 * 8 * 32 * 224 * 4092 * 4093 / 2 / 989e12)
    assert _reader("shared_attn_roofline")(_run()) == pytest.approx(100 * 4 * bound / 3.75)


def test_a_short_core_is_bound_by_its_bytes():
    from gpubench.metrics.shared_attn_roofline import attn_bound_s
    a = dict(ATTN, q_len=1, kv_len=4096)
    assert attn_bound_s(a) == pytest.approx(2 * 8 * 224 * (2 * 32 + 2 * 32 * 4096) / 3.35e12)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_say_nothing_without_device_seconds(tree, name):
    _call(tree)
    tree.records = [dataclasses.replace(r, device_time=None) for r in tree.records]
    assert _reader(name)(_run()) is None
