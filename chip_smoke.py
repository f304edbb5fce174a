#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. Device: the card's name, and `nvidia-smi`'s name and power limit.
2. Build: both kernel libraries (`binary_matvec.cu`, `fused_mlp.cu`)
   with nvcc, started together, into the git-ignored `build/` directory,
   timed, with nvcc's register and shared-memory report.
3. Kernels against their plain PyTorch versions on the card, at the
   main paths' shapes (the paper's 784-500-10 net, 256 rows; 4
   bit-planes on the planes path), seeded random words, bits, weights
   (|w| <= 9) and images, exact equality.
4. Main paths: three seeded 784-500-10 nets served by `NetServer` on
   `Session(device="cuda")`, once per target:
   `cuda[planes=true]` (one `predict` through the per-layer
   `binary_matmul_planes` chain, two `predict_many` calls over 3
   versions with skewed request sizes through the
   `binary_forward_planes` megakernel), then `cuda` (`binary_matmul`),
   `cuda[packed=true]` (`binary_matmul_packed`) and `fused`
   (`fused_mlp_predict`) with the same requests. Every launch count is
   set to 0 just before a path runs and read just after it; each of the
   path's kernels must have launched. Answers must equal
   `predict_quantized` and the `torch` oracle target.
5. Times: CUDA events, median of 20 runs after warmup, per kernel beside
   its plain version, a one-call library yardstick where one exists,
   and its bound; a block-shape sweep of the dense, packed and fused
   kernels at layer-1 shape; then the served rounds' latency per target.

The last two lines are the `{"kernels": [...]}` record and
`{"ok": true, "device": {...}}`. Without CUDA, or without the
repository's `src/` beside it, the script exits non-zero and prints no
result. Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BMV_SOURCE = "src/repro_torch/kernels/binary_matvec/csrc/binary_matvec.cu"
FUSED_SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu"
SOURCES = {
    "binary_matmul_planes": BMV_SOURCE, "binary_forward_planes": BMV_SOURCE,
    "binary_matmul": BMV_SOURCE, "binary_matmul_packed": BMV_SOURCE,
    "fused_mlp_predict": FUSED_SOURCE,
}
REPLACES = {
    "binary_matmul_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:198",
    "binary_forward_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:302",
    "binary_matmul": "src/repro/kernels/binary_matvec/binary_matvec.py:77",
    "binary_matmul_packed": "src/repro/kernels/binary_matvec/binary_matvec.py:134",
    "fused_mlp_predict": "src/repro/kernels/fused_mlp/fused_mlp.py:34",
}
# target -> the kernels its main path must launch
PATHS = {
    "cuda[planes=true]": ("binary_matmul_planes", "binary_forward_planes"),
    "cuda": ("binary_matmul",),
    "cuda[packed=true]": ("binary_matmul_packed",),
    "fused": ("fused_mlp_predict",),
}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
INT8_TC_OPS_PER_S = 1.979e15     # H100 SXM dense int8 tensor cores (data sheet)
# CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: results per clock per SM.
POPC_PER_CLOCK_PER_SM = 16       # row "population count" (__popc)
ADD_PER_CLOCK_PER_SM = 64        # row "32-bit integer add"
N_IN, N_HIDDEN, N_OUT, PLANES = 784, 500, 10, 4
BATCH, MODELS = 256, 3
TIMING_RUNS, TIMING_INNER = 20, 5
SWEEP_BM, SWEEP_BN = (1, 2, 4, 8, 16, 32), (32, 64, 128, 256)


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _words(rng, shape, dev):
    import numpy as np
    import torch
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _ints(rng, lo, hi, shape, dtype, dev):
    import torch
    return torch.from_numpy(rng.integers(lo, hi + 1, size=shape)).to(dtype).to(dev)


def _time_ms(fn, clock_hz: float) -> float:
    """Median device time of one call of `fn`, from CUDA events around
    TIMING_INNER back-to-back calls, after warmup. A spin kernel ahead of
    each run keeps the stream busy while the host enqueues the calls, so
    host overhead stays out of the measured interval."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMING_INNER):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(max(2 * host_s, 1e-3) * clock_hz)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(TIMING_RUNS):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(TIMING_INNER):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / TIMING_INNER)
    return statistics.median(runs)


def _bound(nbytes: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _work(name: str, args, kw) -> tuple[int, str]:
    """(operations, kind) one call of kernel `name` does on `args`:
    popcounts for the bit-plane kernels (2 x rows x P x W x N per layer,
    N the real class count on the last), adds for the others (B x K x N
    per layer; K = KW x 32 for packed words)."""
    if name == "binary_matmul_planes":
        x, pos, _ = args
        return 2 * x.shape[0] * pos.shape[0] * pos.shape[1] * pos.shape[2], "popc"
    if name == "binary_forward_planes":
        x, planes = args[0], args[1:]
        rows = x.numel() // x.shape[-1]
        popc = 0
        for li in range(len(planes) // 2):
            p, w, n = planes[2 * li].shape[-3:]
            if li == len(planes) // 2 - 1:
                n = kw["n_classes"]
            popc += 2 * rows * p * w * n
        return popc, "popc"
    if name in ("binary_matmul", "binary_matmul_packed"):
        x, w = args
        return x.shape[0] * w.shape[0] * w.shape[1], "add"
    x, w1, w2 = args
    return x.shape[0] * (w1.shape[0] * w1.shape[1] + w2.shape[0] * w2.shape[1]), "add"


def _library(name: str, args, out, clock_hz: float):
    """(ms, max_abs_err) of the one-call PyTorch yardstick computing the
    same product, an fp32 `torch.matmul` without TF32 (exact here: every
    sum is an integer below 2**24), or (None, None) where none exists."""
    import torch
    from repro_torch.kernels.binary_matvec import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    if name == "binary_matmul_planes":
        x, pos, neg = args
        k = x.shape[1] * 32
        xf = ref.unpack_bits(x, k).float()
        wf = sum((ref.unpack_bits(pos[b].T.contiguous(), k).T.float()
                  - ref.unpack_bits(neg[b].T.contiguous(), k).T.float())
                 * 2 ** b for b in range(pos.shape[0]))
    elif name == "binary_matmul":
        xf, wf = (args[0] != 0).float(), args[1].float()
    elif name == "binary_matmul_packed":
        xf = ref.unpack_bits(args[0], args[1].shape[0]).float()
        wf = args[1].float()
    else:
        return None, None
    err = int((torch.matmul(xf, wf).long() - out.long()).abs().max().item())
    return _time_ms(lambda: torch.matmul(xf, wf), clock_hz), err


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dataset, quantize
    from repro_torch.kernels.binary_matvec import build, ops, ref
    from repro_torch.kernels.fused_mlp import build as fbuild
    from repro_torch.kernels.fused_mlp import ops as fops
    from repro_torch.kernels.fused_mlp import ref as fref
    from repro_torch.netgen import NetServer, Session

    wrappers = {"binary_matmul_planes": ops.binary_matmul_planes,
                "binary_forward_planes": ops.binary_forward_planes,
                "binary_matmul": ops.binary_matmul,
                "binary_matmul_packed": ops.binary_matmul_packed,
                "fused_mlp_predict": fops.fused_mlp_predict}

    def reset_launches():
        ops.reset_launches()
        fops.reset_launches()

    # -- 1. device ------------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit")
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"popc": POPC_PER_CLOCK_PER_SM * sms * clock_hz,
             "add": ADD_PER_CLOCK_PER_SM * sms * clock_hz}
    print(f"[1 device] {kind}: {sms} SMs, max SM clock {clock_hz / 1e6:.0f} MHz; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # -- 2. build: one nvcc per source, started together ---------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        loads = [pool.submit(b.load) for b in (build, fbuild)]
        for f in loads:
            f.result()
    wall = time.perf_counter() - t0
    for b in (build, fbuild):
        info = b.last_build()
        print(f"[2 build] {info.path.name} compiled={info.compiled} "
              f"nvcc {info.seconds:.1f} s")
        for line in info.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("    " + line.strip())
    print(f"[2 build] both libraries loaded in {wall:.1f} s")

    # -- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED)
    hidden_pad = -(-N_HIDDEN // 32) * 32
    w1, w2 = -(-N_IN // 32), hidden_pad // 32
    thr = quantize.INPUT_THRESHOLD
    cases = {name: {} for name in wrappers}
    for label, (kw, n) in {"layer1": (w1, N_HIDDEN), "layer2": (w2, N_OUT)}.items():
        args = (_words(rng, (BATCH, kw), dev), _words(rng, (PLANES, kw, n), dev),
                _words(rng, (PLANES, kw, n), dev))
        cases["binary_matmul_planes"][label] = (
            args, {}, ops.binary_matmul_planes, ref.plane_matmul)
    for label, lead in {"single": (), "stacked": (MODELS,)}.items():
        x = torch.from_numpy(rng.integers(
            0, 256, size=(*lead, BATCH, N_IN), dtype=np.uint8)).to(dev)
        planes = []
        for kw, n in ((w1, hidden_pad), (w2, N_OUT)):
            planes += [_words(rng, (*lead, PLANES, kw, n), dev) for _ in range(2)]
        kw_args = {"threshold": thr, "n_classes": N_OUT}
        cases["binary_forward_planes"][label] = (
            (x, *planes), kw_args, ops.binary_forward_planes, ref.forward_planes)
    for label, (k, n) in {"layer1": (N_IN, N_HIDDEN), "layer2": (N_HIDDEN, N_OUT)}.items():
        args = (_ints(rng, 0, 1, (BATCH, k), torch.int8, dev),
                _ints(rng, -9, 9, (k, n), torch.int32, dev))
        cases["binary_matmul"][label] = (args, {}, ops.binary_matmul, ref.binary_matmul)
    for label, (kw, n) in {"layer1": (w1, N_HIDDEN), "layer2": (w2, N_OUT)}.items():
        args = (_words(rng, (BATCH, kw), dev),
                _ints(rng, -9, 9, (kw * 32, n), torch.int32, dev))
        cases["binary_matmul_packed"][label] = (
            args, {}, ops.binary_matmul_packed, ref.binary_matmul_packed)
    args = (torch.from_numpy(rng.integers(0, 256, size=(BATCH, N_IN), dtype=np.uint8)).to(dev),
            _ints(rng, -9, 9, (N_IN, N_HIDDEN), torch.int32, dev),
            _ints(rng, -9, 9, (N_HIDDEN, N_OUT), torch.int32, dev))
    cases["fused_mlp_predict"]["net"] = (
        args, {"threshold": thr}, fops.fused_mlp_predict, fref.fused_mlp_predict)
    errors = {}
    for name, shapes in cases.items():
        for label, (args, kw, kernel, plain) in shapes.items():
            got, want = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max().item())
            errors[name, label] = err
            print(f"[3 kernel] {name}[{label}] {tuple(got.shape)} "
                  f"max_abs_err={err}")
            if not torch.equal(got, want):
                raise AssertionError(f"{name}[{label}] disagrees with its plain version")

    # -- 4. main paths --------------------------------------------------------
    nets = []
    for v in range(MODELS):
        r = np.random.default_rng(SEED + 1 + v)
        nets.append(quantize.QuantizedNet(
            w1=quantize.int_cast_weights(r.normal(0, N_IN ** -0.5, (N_IN, N_HIDDEN))),
            w2=quantize.int_cast_weights(r.normal(0, N_HIDDEN ** -0.5, (N_HIDDEN, N_OUT)))))
    images, _ = dataset.make_dataset(1200, seed=SEED)
    session = Session(device="cuda")
    rounds = [{"v0": images[:600], "v1": images[600:900], "v2": images[900:940]},
              {"v0": images[:256], "v1": images[256:512], "v2": images[512:768]}]
    oracle = NetServer(session=session, target="torch", slot_capacity=BATCH)
    for v, net in enumerate(nets):
        oracle.register(f"v{v}", net)

    servers, launches = {}, {}
    for target, kernels in PATHS.items():
        reset_launches()
        t0 = time.perf_counter()
        server = NetServer(session=session, target=target, slot_capacity=BATCH)
        for v, net in enumerate(nets):
            server.register(f"v{v}", net)
        served = [({"v0": images[:300]}, {"v0": server.predict("v0", images[:300])})]
        served += [(req, server.predict_many(req)) for req in rounds]
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = {name: wrappers[name].launches for name in wrappers}
        print(f"[4 main path] {target}: {main_s:.2f} s, dispatch "
              f"{server.dispatch_counts}, launches {counts}")
        for name in kernels:
            if counts[name] <= 0:
                raise AssertionError(f"the {target} path never launched {name}")
            launches[name] = counts[name]
        for req, out in served:
            for v, x in req.items():
                net = nets[int(v[1:])]
                got = out[v]
                if got.shape != (x.shape[0],) or got.min() < 0 or got.max() >= N_OUT:
                    raise AssertionError(f"{target} {v}: bad predictions {got.shape}")
                want = quantize.predict_quantized(net, device=dev)(x).cpu().numpy()
                if not np.array_equal(got, want):
                    raise AssertionError(f"{target} {v}: served answers != predict_quantized")
                if not np.array_equal(got, oracle.predict(v, x)):
                    raise AssertionError(f"{target} {v}: served answers != torch target")
        print(f"[4 main path] {target}: "
              f"{sum(x.shape[0] for req, _ in served for x in req.values())} "
              "answers equal predict_quantized and the torch target")
        servers[target] = server

    # -- 5. times -------------------------------------------------------------
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    records = []
    for name, shapes in cases.items():
        per_shape = []
        for label, (args, kw, kernel, plain) in shapes.items():
            out = kernel(*args, **kw)
            moved = nbytes(args) + nbytes([out])
            work, op = _work(name, args, kw)
            library_ms, lib_err = _library(name, args, out, clock_hz)
            bound_ms, bound_by = _bound(moved, work, rates[op])
            rec = {
                "shape": label,
                "ms": _time_ms(lambda: kernel(*args, **kw), clock_hz),
                "plain_ms": _time_ms(lambda: plain(*args, **kw), clock_hz),
                "library_ms": library_ms, "library_max_abs_err": lib_err,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": moved, "popcounts" if op == "popc" else "adds": work,
                "max_abs_err": errors[name, label],
            }
            if name in ("binary_matmul", "binary_matmul_packed"):
                rec["int8_tc_floor_ms"] = 2 * work / INT8_TC_OPS_PER_S * 1e3
            per_shape.append(rec)
            print(json.dumps({"kernel": name, **rec}))
        head = per_shape[-1] if name == "binary_forward_planes" else per_shape[0]
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "timed_shape": head["shape"],
            "shapes": per_shape,
        })

    sweep = {}
    for name in ("binary_matmul", "binary_matmul_packed"):
        args, _, kernel, _ = cases[name]["layer1"]
        sweep[name] = {f"bm={bm},bn={bn}": _time_ms(
            lambda: kernel(*args, bm=bm, bn=bn), clock_hz)
            for bm in SWEEP_BM for bn in SWEEP_BN}
    args, kw, kernel, _ = cases["fused_mlp_predict"]["net"]
    sweep["fused_mlp_predict"] = {f"bm={bm}": _time_ms(
        lambda: kernel(*args, bm=bm, **kw), clock_hz) for bm in SWEEP_BM}
    print(json.dumps({"sweep_ms": sweep, "defaults": {
        "binary_matmul": [ops.DENSE_BM, ops.DENSE_BN],
        "binary_matmul_packed": [ops.PACKED_BM, ops.PACKED_BN],
        "fused_mlp_predict": fops.FUSED_BM}}))

    latency = {}
    for target, server in servers.items():
        calls = {"stacked_round_3x256": lambda: server.predict_many(rounds[1]),
                 "single_round_256": lambda: server.predict("v0", images[:BATCH])}
        for label, call in calls.items():
            call()
            ts = []
            for _ in range(TIMING_RUNS):
                t0 = time.perf_counter()
                call()
                ts.append((time.perf_counter() - t0) * 1e3)
            latency[f"{target} {label}"] = statistics.median(ts)
    print(json.dumps({"served_round_ms": latency, "device": kind, "power": smi}))

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
