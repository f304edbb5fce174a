"""The port's kernel autotuner and tile legality against the JAX package's,
on the CPU.

`repro_torch.netgen.tune` (records, store, tuner counters), the
`cuda[tuned=true]` / `fused[tuned=true]` targets through `Session(
tune_store=...)` and the serving layer, and `analysis.tile_report` on
Hopper's shared-memory budget, held to the reference's record format
and to the kernels' own host-side checks. Integer answers are compared
exactly.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import quantize as jquantize
from repro.netgen import tune as jtune
from repro_torch import netgen
from repro_torch.core import quantize
from repro_torch.kernels.binary_matvec import ops as bmv
from repro_torch.kernels.fused_mlp import ops as fops
from repro_torch.kernels.launch import SMEM_LIMIT
from repro_torch.netgen import analysis, session as session_mod, tune
from repro_torch.netgen.backends import cuda as cuda_backend
from repro_torch.netgen.plan import ExecutionPlan, PlanLayer, lower_circuit

from _netgen_helpers import images, random_net

ROOT = Path(__file__).resolve().parent.parent
SIZES = (20, 16, 4)
FORMS = ("dense", "packed", "planes", "fusednet")


def _net(seed: int, sizes=SIZES):
    return random_net(seed, sizes, lo=-5, hi=5)


def _want(net, x) -> np.ndarray:
    return np.asarray(jquantize.predict_quantized(net)(jnp.asarray(x)))


def _session(tmp_path, name="a", **kw):
    return netgen.Session(device="cpu", store=tmp_path / f"art-{name}",
                          tune_store=tmp_path / f"tune-{name}", **kw)


# ---------------------------------------------------------------------------
# Records, store, tuner
# ---------------------------------------------------------------------------

def test_tune_records_cross_between_the_packages(tmp_path):
    """A record written by either package's TuneStore reads back equal in
    the other's, under the same content address."""
    fields = {"target": "cuda", "device_kind": "cpu", "batch": 256,
              "signature": {"n_inputs": 20, "widths": [16, 4]},
              "candidates": [{"form": "dense", "bm": 32, "bn": 32}]}
    assert tune.tune_key(fields) == jtune.tune_key(fields)
    rec = tune.TuneRecord(key=tune.tune_key(fields), best={"form": "dense", "bm": 4},
                          measurements=(({"bm": 4}, 12.5), ({"bm": 32}, 20.0)),
                          device_kind="cpu", created_unix=1.0, extra={"trace": [1, 2]})
    tune.TuneStore(tmp_path / "port").put(rec)
    back = jtune.TuneStore(tmp_path / "port").get(rec.key)
    assert back is not None and back.as_dict() == rec.as_dict()
    jrec = jtune.TuneRecord(key="k" * 64, best={"bm": 8, "bn": 64},
                            measurements=(({"bm": 8}, 3.0),), device_kind="TPU v5e",
                            created_unix=2.0)
    jtune.TuneStore(tmp_path / "jax").put(jrec)
    got = tune.TuneStore(tmp_path / "jax").get(jrec.key)
    assert got is not None and got.as_dict() == jrec.as_dict()
    assert json.loads((tmp_path / "jax" / f"{jrec.key}.json").read_text())["format"] \
        == "netgen-tune-v1"


def test_tuner_picks_argmin_and_counts_like_the_reference():
    tuner = tune.KernelTuner()
    cost = {1: 3e-3, 2: 1e-3, 3: 2e-3}
    calls = []

    def measure(c):
        calls.append(c["x"])
        return cost[c["x"]]

    cands = [{"x": 1}, {"x": 2}, {"x": 3}]
    assert tuner.get_or_tune({"problem": 1}, cands, measure, reps=2) == {"x": 2}
    assert len(calls) == 9                        # warmup + 2 reps each
    st = tuner.stats
    assert (st.hits, st.store_hits, st.tunes, st.measurements) == (0, 0, 1, 3)
    assert tuner.get_or_tune({"problem": 1}, cands, measure) == {"x": 2}
    assert len(calls) == 9 and tuner.stats.hits == 1
    legal = lambda c: None if c["x"] != 2 else "odd"        # noqa: E731
    assert tuner.get_or_tune({"problem": 2}, cands, measure, legal=legal) == {"x": 3}
    assert tuner.stats.rejected == 1
    with pytest.raises(ValueError, match="statically illegal"):
        tuner.get_or_tune({"problem": 3}, cands, measure, legal=lambda c: "no")


def test_tune_store_round_trip_and_corruption(tmp_path):
    store = tune.TuneStore(tmp_path)
    t1 = tune.KernelTuner(store)
    t1.get_or_tune({"p": 1}, [{"x": 1}, {"x": 2}], lambda c: c["x"] * 1e-3)
    t2 = tune.KernelTuner(tune.TuneStore(tmp_path))
    assert t2.get_or_tune({"p": 1}, [{"x": 1}, {"x": 2}],
                          lambda c: pytest.fail("re-measured")) == {"x": 1}
    assert (t2.stats.store_hits, t2.stats.measurements) == (1, 0)
    key = tune.tune_key({"p": 1})
    (tmp_path / f"{key}.json").write_text("{not json")
    assert store.get(key) is None and key not in store          # evicted
    t3 = tune.KernelTuner(store)
    t3.get_or_tune({"p": 1}, [{"x": 1}, {"x": 2}], lambda c: c["x"] * 1e-3)
    assert t3.stats.tunes == 1                                   # re-tuned


def test_device_kind_keys_the_cpu_and_names_cuda_devices():
    assert tune.device_kind("cpu") == "cpu"
    assert tune.device_kind(torch.device("cpu")) == "cpu"


# ---------------------------------------------------------------------------
# tuned=true targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", [
    "cuda[tuned=true]", "cuda[tuned=true,planes=true]", "cuda[tuned=true,packed=true]",
    "cuda[tuned=true,fusednet=true]", "fused[tuned=true]"])
def test_tuned_targets_answer_like_predict_quantized(tmp_path, target):
    net = _net(3)
    x = images(3, 40, SIZES[0], salt=7)
    session = _session(tmp_path)
    art = session.compile(net, target=target)
    got = art(x)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _want(net, x))
    np.testing.assert_array_equal(
        got.numpy(), quantize.predict_quantized(net, device="cpu")(x).numpy())
    ts = session.tune_stats()
    assert ts.tunes == 1 and ts.measurements >= 1
    # the store key names the target string, never the tuner's choice
    spec = netgen.PipelineSpec.coerce("default")
    canonical = netgen.targets.target_string(*netgen.resolve_target(target))
    assert art.target == canonical and "bm=" not in canonical
    assert art.key == session_mod.artifact_key(net.digest(), spec, canonical)
    if "fused" not in target and "=true," in target:
        form = target.split(",")[1].split("=")[0]
        assert art.artifact.datapath == form
    if target == "fused[tuned=true]":
        # the int8 route takes 16 rows whatever bm: one launch shape, one measurement
        assert (ts.measurements, ts.rejected) == (1, len(cuda_backend._FUSED_TUNE_BM) - 1)


def test_tuned_search_covers_every_datapath_and_records_the_surface(tmp_path):
    net = _net(4)
    session = _session(tmp_path)
    art = session.compile(net, target="cuda[tuned=true]")
    store = session.tuner.store
    (key,) = store.keys()
    rec = store.get(key)
    forms = {p["form"] for p, _ in rec.measurements}
    assert forms == set(FORMS)
    assert all(set(p) == {"form", "bm", "bn"} and us > 0 for p, us in rec.measurements)
    assert rec.best == min(rec.measurements, key=lambda t: t[1])[0]
    assert art.artifact.datapath == rec.best["form"]
    assert art.artifact.blocks == {"bm": rec.best["bm"], "bn": rec.best["bn"]}
    # every grid tile is one a kernel takes, each form's default among them
    grid = {(t["bm"], t["bn"]) for t in cuda_backend._TUNE_BLOCKS}
    assert {(bmv.MMA_BM, bmv.MMA_BN), (bmv.DENSE_BM, bmv.DENSE_BN),
            (bmv.PACKED_BM, bmv.PACKED_BN), (bmv.MATMUL_BM, bmv.MATMUL_BN)} <= grid
    assert bmv.FORWARD_BM in {bm for bm, _ in grid}
    assert fops.FUSED_BM in cuda_backend._FUSED_TUNE_BM
    for bm, bn in grid:
        assert bmv.check_matmul_blocks(bm, bn) == (bm, bn)


def test_pinned_options_restrict_the_search(tmp_path):
    session = _session(tmp_path)
    art = session.compile(_net(5), target="cuda[tuned=true,packed=true,bm=8]")
    (key,) = session.tuner.store.keys()
    rec = session.tuner.store.get(key)
    assert {p["form"] for p, _ in rec.measurements} == {"packed"}
    assert {p["bm"] for p, _ in rec.measurements} == {8}
    assert art.artifact.blocks["bm"] == 8


def test_bkw_has_no_counterpart_on_the_card(tmp_path):
    session = _session(tmp_path)
    for target in ("cuda[bkw=8]", "cuda[tuned=true,bkw=16]", "cuda[planes=true,bkw=8]"):
        with pytest.raises(ValueError, match="bkw has no counterpart on the card"):
            session.compile(_net(6), target=target)
    plan = lower_circuit(netgen.lower(quantize.from_numpy(
        random_net(6, SIZES).weights)))
    stacked = netgen.stack_plans([plan, plan])
    with pytest.raises(ValueError, match="bkw"):
        cuda_backend.compile_cuda_multi(stacked, device=torch.device("cpu"),
                                        planes=True, bkw=8)


def test_tuned_netserver_stacked_dispatch_uses_the_session_tuner(tmp_path):
    session = _session(tmp_path)
    server = netgen.NetServer(session=session, target="cuda[tuned=true]",
                              slot_capacity=16)
    nets = {f"v{i}": _net(10 + i) for i in range(3)}
    for name, net in nets.items():
        server.register(name, net)
    reqs = {name: images(20 + i, 16, SIZES[0]) for i, name in enumerate(nets)}
    out = server.predict_many(reqs)
    for name, x in reqs.items():
        np.testing.assert_array_equal(out[name], _want(nets[name], x))
    assert server.dispatch_counts["stacked"] >= 1
    # the three nets share one shape (and plane count): one search for
    # them, one for the stacked plan
    ts = session.tune_stats()
    assert (ts.tunes, ts.hits) == (2, 2)
    assert len(session.tuner.store.keys()) == 2


def test_warm_second_process_measures_nothing(tmp_path):
    """A fresh process over the same ArtifactStore + TuneStore rebuilds
    `cuda[tuned=true]` and `fused[tuned=true]` with zero compiles and zero
    measurements, and answers the same."""
    script = f"""
import json, sys
sys.path.insert(0, {str(ROOT / "tests")!r})
from _netgen_helpers import random_net, images
from repro_torch import netgen
from repro_torch.core import quantize
net = quantize.from_numpy(random_net(10, (20, 16, 4), lo=-5, hi=5).weights)
x = images(10, 12, 20, salt=77)
session = netgen.Session(device="cpu", store={str(tmp_path / "art")!r},
                         tune_store={str(tmp_path / "tune")!r})
out = {{}}
for target in ("cuda[tuned=true]", "fused[tuned=true]"):
    art = session.compile(net, target=target)
    out[target] = {{"key": art.key, "blocks": art.artifact.blocks,
                   "datapath": art.artifact.datapath, "preds": art(x).tolist()}}
ts = session.tune_stats()
print(json.dumps({{"targets": out, "compiles": session.stats().compiles,
                  "tunes": ts.tunes, "measurements": ts.measurements}}))
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = [json.loads(subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, check=True,
        env=env, timeout=300).stdout.strip().splitlines()[-1]) for _ in range(2)]
    cold, warm = runs
    assert cold["compiles"] == 2 and cold["tunes"] == 2 and cold["measurements"] > 0
    assert (warm["compiles"], warm["tunes"], warm["measurements"]) == (0, 0, 0)
    assert warm["targets"] == cold["targets"]
    x = images(10, 12, 20, salt=77)
    np.testing.assert_array_equal(cold["targets"]["cuda[tuned=true]"]["preds"],
                                  _want(_net(10), x))


# ---------------------------------------------------------------------------
# Tile legality on Hopper's budget
# ---------------------------------------------------------------------------

def _plan(w1, w2) -> ExecutionPlan:
    return ExecutionPlan(n_inputs=w1.shape[0], input_threshold=128, layers=(
        PlanLayer(weights=w1.astype(np.int32), activation="step"),
        PlanLayer(weights=w2.astype(np.int32), activation="argmax")))


def _kernel_check(plan: ExecutionPlan, form: str, cand: dict) -> None:
    """The kernels' own host-side checks for a candidate, raising
    ValueError where a kernel would refuse it."""
    bm, bn = cand["bm"], cand.get("bn")
    if form == "fusednet":
        bmv.check_forward_planes(plan.megakernel_view().layer_words, bm)
    elif form == "fused":
        (k, h), o = plan.layers[0].weights.shape, plan.layers[1].fan_out
        fops.check_fused(k, h, o, bm, mma=cuda_backend._fits_int8(plan))
    else:
        bmv.check_matmul_blocks(bm, bn)
        if form == "planes":
            for layer in plan.planes().layers:
                if bmv.planes_smem_bytes(bm, layer.n_planes) > SMEM_LIMIT:
                    raise ValueError("planes shared memory")


def test_tile_report_agrees_with_the_kernels_own_checks():
    """Every candidate `tile_report` admits passes the kernel's own check;
    every candidate it refuses for the budget is refused by that check.
    The 784-500-10 paper net, a wide-hidden net whose megakernel
    overflows shared memory at 32 rows (budget rejections), and an int32
    net (the scalar routes)."""
    rng = np.random.default_rng(0)
    plans = {
        "paper": _plan(rng.integers(-9, 10, (784, 500)), rng.integers(-9, 10, (500, 10))),
        "wide": _plan(rng.integers(-3, 4, (32, 30000)), rng.integers(-3, 4, (30000, 10))),
        "int32": _plan(rng.integers(-300, 301, (64, 96)), rng.integers(-300, 301, (96, 10))),
    }
    extra = [{"bm": 16, "bn": 64}, {"bm": 2, "bn": 1024}, {"bm": 3, "bn": 32},
             {"bm": 8, "bn": 48}, {"bm": 0, "bn": 32}]
    budget_rejections = 0
    for name, plan in plans.items():
        for form in (*FORMS, "fused"):
            cands = [{"form": form, **t} for t in (*cuda_backend._TUNE_BLOCKS, *extra)]
            if form == "fused":
                cands += [{"form": form, "bm": b} for b in cuda_backend._FUSED_TUNE_BM]
            legal, rejected = analysis.tile_report(plan, cands, batch=256)
            assert legal, (name, form)
            for cand in legal:
                _kernel_check(plan, form, cand)
            for cand, reason in rejected:
                if "budget" in reason or "refused by the kernel" in reason:
                    budget_rejections += "budget" in reason
                    with pytest.raises(ValueError):
                        _kernel_check(plan, form, cand)
                else:
                    assert "duplicate kernel" in reason or "non-positive" in reason, reason
    assert budget_rejections >= 1
    wide = plans["wide"]
    assert analysis.fusednet_smem_bytes(wide, bm=32) > analysis.FUSEDNET_SMEM_BYTES
    assert analysis.fusednet_smem_bytes(wide, bm=8) <= analysis.FUSEDNET_SMEM_BYTES
    assert analysis.FUSEDNET_SMEM_BYTES == SMEM_LIMIT == 232_448


def test_effective_tiles_follow_the_ports_clamps():
    rng = np.random.default_rng(1)
    paper = _plan(rng.integers(-9, 10, (784, 500)), rng.integers(-9, 10, (500, 10)))
    words, planes = paper.megakernel_view().layer_words, paper.megakernel_view().layer_planes
    assert analysis._plan_words(paper) == list(words)
    assert analysis._plan_planes(paper) == list(planes)
    eff = analysis.effective_tiles
    # int8 weights: the tensor-core route's 16/32-row tiles, bn clamped to the width
    assert eff(paper, "dense", {"bm": 4, "bn": 128}, 256) \
        == eff(paper, "dense", {"bm": 16, "bn": 128}, 256) \
        == (("mma", 16, 128), ("mma", 16, 32))
    assert eff(paper, "planes", {"bm": 32, "bn": 1024}, 256)[0] == ("mma", 32, 512)
    assert eff(paper, "fusednet", {"bm": 8, "bn": 32}, 256) \
        == eff(paper, "fusednet", {"bm": 1, "bn": 1024}, 256) == (("mma", 16),)
    assert eff(paper, "fused", {"bm": 2}, 256) == eff(paper, "fused", {"bm": 8}, 256)
    wide32 = _plan(rng.integers(-300, 301, (64, 96)), rng.integers(-300, 301, (96, 10)))
    assert eff(wide32, "dense", {"bm": 4, "bn": 128}, 256)[0] == ("scalar", 4, 128)
    assert eff(wide32, "fused", {"bm": 2}, 256) != eff(wide32, "fused", {"bm": 8}, 256)
    assert analysis.fusednet_smem_bytes(paper, bm=8) == bmv.forward_mma_smem_bytes(
        planes, words, 8)
