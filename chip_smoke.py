#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. Device: the card's name, and `nvidia-smi`'s name and power limit.
2. Build: the bit-plane kernels from `csrc/binary_matvec.cu` with nvcc,
   into the git-ignored `build/` directory, timed.
3. Kernels against their plain PyTorch versions on the card, at the
   main path's shapes (the paper's 784-500-10 net at 4 bit-planes),
   seeded random words and images, exact equality.
4. Main path: three seeded 784-500-10 nets served by
   `NetServer(target="cuda[planes=true]")` on `Session(device="cuda")`:
   one `predict` (the per-layer `binary_matmul_planes` chain) and two
   `predict_many` calls over 3 versions with skewed request sizes (the
   `binary_forward_planes` megakernel). Answers must equal
   `predict_quantized` and the `torch` oracle target, and both kernels'
   launch counters must be > 0.
5. Times: CUDA events, median of 20 runs after warmup, per kernel beside
   its plain version, a one-call library yardstick where one exists,
   and its bound; then the served round's latency.

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
SOURCE = "src/repro_torch/kernels/binary_matvec/csrc/binary_matvec.cu"
REPLACES = {
    "binary_matmul_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:198",
    "binary_forward_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:302",
}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
POPC_PER_CLOCK_PER_SM = 16       # __popc, CUDA C++ Programming Guide, cc 9.0
N_IN, N_HIDDEN, N_OUT, PLANES = 784, 500, 10, 4
BATCH, MODELS = 256, 3
TIMING_RUNS, TIMING_INNER = 20, 5


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _words(rng, shape, dev):
    import numpy as np
    import torch
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


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


def _bound(nbytes: int, popcounts: int, popc_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = popcounts / popc_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dataset, quantize
    from repro_torch.kernels.binary_matvec import build, ops, ref
    from repro_torch.netgen import NetServer, Session

    # -- 1. device ------------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit")
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_per_s = POPC_PER_CLOCK_PER_SM * sms * clock_hz
    print(f"[1 device] {kind}: {sms} SMs, max SM clock {clock_hz / 1e6:.0f} MHz; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    info = build.last_build()
    print(f"[2 build] {info.path.name}"
          f" compiled={info.compiled} nvcc {info.seconds:.1f} s, "
          f"load {time.perf_counter() - t0:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    " + line.strip())

    # -- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED)
    hidden_pad = -(-N_HIDDEN // 32) * 32
    w1, w2 = -(-N_IN // 32), hidden_pad // 32
    cases = {"binary_matmul_planes": {}, "binary_forward_planes": {}}
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
        kw_args = {"threshold": quantize.INPUT_THRESHOLD, "n_classes": N_OUT}
        cases["binary_forward_planes"][label] = (
            (x, *planes), kw_args, ops.binary_forward_planes, ref.forward_planes)
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

    # -- 4. main path ---------------------------------------------------------
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

    ops.reset_launches()
    t0 = time.perf_counter()
    server = NetServer(session=session, target="cuda[planes=true]",
                       slot_capacity=BATCH)
    for v, net in enumerate(nets):
        server.register(f"v{v}", net)
    served = [({"v0": images[:300]}, {"v0": server.predict("v0", images[:300])})]
    served += [(req, server.predict_many(req)) for req in rounds]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"binary_matmul_planes": ops.binary_matmul_planes.launches,
                "binary_forward_planes": ops.binary_forward_planes.launches}
    print(f"[4 main path] {main_s:.2f} s, dispatch {server.dispatch_counts}, "
          f"launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    oracle = NetServer(session=session, target="torch", slot_capacity=BATCH)
    for v, net in enumerate(nets):
        oracle.register(f"v{v}", net)
    for req, out in served:
        for v, x in req.items():
            net = nets[int(v[1:])]
            got = out[v]
            if got.shape != (x.shape[0],) or got.min() < 0 or got.max() >= N_OUT:
                raise AssertionError(f"{v}: bad predictions {got.shape}")
            want = quantize.predict_quantized(net, device=dev)(x).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{v}: served answers != predict_quantized")
            if not np.array_equal(got, oracle.predict(v, x)):
                raise AssertionError(f"{v}: served answers != torch target")
    print(f"[4 main path] {sum(x.shape[0] for req, _ in served for x in req.values())} "
          "answers equal predict_quantized and the torch target")

    # -- 5. times -------------------------------------------------------------
    def layer_bytes(args):
        return sum(t.numel() * t.element_size() for t in args)

    records = []
    for name, shapes in cases.items():
        per_shape = []
        for label, (args, kw, kernel, plain) in shapes.items():
            out = kernel(*args, **kw)
            nbytes = layer_bytes(args) + out.numel() * out.element_size()
            if name == "binary_matmul_planes":
                x, pos, neg = args
                popc = 2 * x.shape[0] * pos.shape[0] * pos.shape[1] * pos.shape[2]
                xf = ref.unpack_bits(x, x.shape[1] * 32).float()
                wf = sum((ref.unpack_bits(pos[b].T.contiguous(), x.shape[1] * 32).T.float()
                          - ref.unpack_bits(neg[b].T.contiguous(), x.shape[1] * 32).T.float())
                         * 2 ** b for b in range(pos.shape[0]))
                torch.backends.cuda.matmul.allow_tf32 = False
                lib_err = int((torch.matmul(xf, wf).long() - out.long()).abs().max().item())
                library_ms = _time_ms(lambda: torch.matmul(xf, wf), clock_hz)
            else:
                x, planes = args[0], args[1:]
                rows = x.numel() // x.shape[-1]
                popc = 0
                for li in range(len(planes) // 2):
                    p, w, n = planes[2 * li].shape[-3:]
                    if li == len(planes) // 2 - 1:
                        n = kw["n_classes"]
                    popc += 2 * rows * p * w * n
                lib_err, library_ms = None, None
            bound_ms, bound_by = _bound(nbytes, popc, popc_per_s)
            rec = {
                "shape": label,
                "ms": _time_ms(lambda: kernel(*args, **kw), clock_hz),
                "plain_ms": _time_ms(lambda: plain(*args, **kw), clock_hz),
                "library_ms": library_ms, "library_max_abs_err": lib_err,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "popcounts": popc,
                "max_abs_err": errors[name, label],
            }
            per_shape.append(rec)
            print(json.dumps({"kernel": name, **rec}))
        head = per_shape[0] if name == "binary_matmul_planes" else per_shape[-1]
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "timed_shape": head["shape"],
            "shapes": per_shape,
        })

    latency = {}
    for label, call in {
            "stacked_round_3x256": lambda: server.predict_many(rounds[1]),
            "single_round_256": lambda: server.predict("v0", images[:BATCH])}.items():
        call()
        ts = []
        for _ in range(TIMING_RUNS):
            t0 = time.perf_counter()
            call()
            ts.append((time.perf_counter() - t0) * 1e3)
        latency[label] = statistics.median(ts)
    print(json.dumps({"served_round_ms": latency, "device": kind, "power": smi}))

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
