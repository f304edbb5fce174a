"""The paper's full pipeline at full size on the PyTorch/CUDA port: train
784-500-10 on the card, apply the ladder, compile through the
`repro_torch.netgen` Session API (frontend -> declarative PipelineSpec
-> Target), emit the full-network Verilog artifact, price the circuit
with the `cost` target (paper Figure 7), check the card's specialized
predictors against L3 and time them, and finally serve TWO ladder
depths through the compile cache: two trained stacks become registered
model versions behind one `NetServer`, re-registration is a cache hit,
and same-topology versions share one stacked multi-net dispatch.

The counterpart of `examples/mnist_fpga_pipeline.py`, with the same
flags, importing only `repro_torch`:

  PYTHONPATH=src python examples/torch_mnist_fpga_pipeline.py [--fast]
      [--deep] [--store DIR] [--tune-store DIR] [--trace DIR]
      [--device cpu]

--deep swaps in a 3-layer hidden stack. --store points the Session at a
persistent ArtifactStore directory: a second run warm-starts every
compilation from disk. --tune-store persists the kernel tuner's records
(`cuda[tuned=true,planes=true]`): a second run measures nothing.
--trace DIR turns on telemetry span tracing and writes DIR/trace.jsonl
(`benchmarks/check_trace.py` gates it) and DIR/metrics.prom, then
prints the telemetry report. --device picks the torch device (default:
the card, cuda:0).
"""
import argparse
import time
from pathlib import Path

import numpy as np

from repro_torch import netgen
from repro_torch.core import dataset, mlp, quantize
from repro_torch.netgen import telemetry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--deep", action="store_true",
                    help="3-layer hidden stack instead of the paper's one")
    ap.add_argument("--store", default=None,
                    help="ArtifactStore directory (persist compilations "
                         "across runs/processes)")
    ap.add_argument("--tune-store", default=None,
                    help="TuneStore directory (persist kernel tuning "
                         "records; a second run re-measures nothing)")
    ap.add_argument("--verilog-out", default="/tmp/nn_inference_full.v")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="enable telemetry tracing + profiling; write "
                         "DIR/trace.jsonl and DIR/metrics.prom and print "
                         "the telemetry report at the end")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    args = ap.parse_args()
    if args.trace:
        telemetry.enable(profile=True)
    if args.deep:
        n_hidden = (128, 64) if args.fast else (500, 128)
    else:
        n_hidden = 128 if args.fast else 500
    epochs = 25 if args.fast else 60

    session = netgen.Session(device=args.device, store=args.store,
                             tune_store=args.tune_store)
    dev = session.device
    if args.store:
        print(f"== artifact store: {args.store} "
              f"({len(session.store.keys())} artifacts resident) ==")
    if args.tune_store:
        print(f"== tune store: {args.tune_store} "
              f"({len(session.tuner.store.keys())} records resident) ==")

    print(f"== train (paper §II.A: 1000 imgs, backprop) on {dev} ==")
    xtr, ytr, xte, yte = dataset.train_test_split(1000, 1000, seed=0)
    cfg = mlp.MLPConfig(n_hidden=n_hidden, epochs=epochs, lr=2.0, seed=42)
    t0 = time.time()
    params = mlp.train(cfg, xtr, ytr, device=dev)
    print(f"trained in {time.time()-t0:.1f}s (layers: {mlp.layer_sizes(cfg)})")

    accs = {
        "L0 sigmoid fp32 (paper 98%)": mlp.predict_l0(params, dev),
        "L1 step act    (paper 95%)": quantize.predict_l1(params, dev),
        "L2 binary in   (paper 94%)": quantize.predict_l2(params, dev),
        "L3 int weights (paper 92%)": quantize.predict_l3(params, dev),
    }
    for name, fn in accs.items():
        print(f"  {name}: {mlp.accuracy(fn, xte, yte):.1%}")

    print("\n== netgen compile (paper §IV-§V as a Session compile) ==")
    qnet = quantize.quantize(params)
    art = session.compile(qnet, target="torch")      # pipeline="default"
    for s in art.pass_stats:
        print(f"  {s.row()}")
    zero_del = art.pass_stats[0]               # the "zeros" pass
    final = art.pass_stats[-1].after
    print(f"  zero weights deleted at generation: "
          f"{1 - zero_del.after.terms / zero_del.before.terms:.1%} (paper: ~50%)")
    print(f"  multiplies: {zero_del.before.terms} -> 0 (addend form); "
          f"adds: {final.addend_units}")
    if art.source == "store":
        print(f"  loaded from store in {art.timings['load_s']*1e3:.0f} ms "
              f"(original compile: {art.timings['total_s']*1e3:.0f} ms)")
    else:
        print(f"  compile: {art.timings['total_s']*1e3:.0f} ms")

    # one hardware pipeline string, used by BOTH the cost report and the
    # Verilog emission so they price/emit the same circuit: the paper's
    # L4 pruning, plus the L5 addend rewrite unless --fast
    hw_pipeline = "zeros,prune" if args.fast else "zeros,prune,addends"

    cost = session.compile(qnet, target="cost", pipeline=hw_pipeline).artifact
    print("  logic-cell estimate per pass (paper Fig. 7):")
    for stage, cells in cost.per_pass:
        print(f"    {stage}: {cells.total}")

    t0 = time.time()
    v = session.compile(
        qnet, target="verilog", pipeline=hw_pipeline,
        addend=not args.fast).artifact
    with open(args.verilog_out, "w") as f:
        f.write(v)
    print(f"  full Verilog artifact: {len(v)/1e6:.1f} MB, "
          f"{len(v.splitlines())} lines in {time.time()-t0:.0f}s "
          f"-> {args.verilog_out}")

    print(f"\n== specialized inference on {dev} (exactness + throughput) ==")
    l3 = quantize.predict_l3(params, dev)(xte)
    targets = ["torch", "cuda", "cuda[tuned=true,planes=true]"]
    if not args.deep:
        targets.append("fused")
    for target in targets:
        art = session.compile(qnet, target=target)
        fn = art.artifact
        exact = bool((fn(xte) == l3).all())
        t0 = time.perf_counter()
        fn(xte).cpu()                                # answers on the host
        dt = time.perf_counter() - t0
        form = f" form={art.plan_form} blocks={fn.blocks}" if "tuned" in target else ""
        print(f"  target={target:30s} exact={exact} "
              f"{len(xte)/dt:,.0f} preds/s (host clock){form}")
    if session.tuner is not None:
        print(f"  {session.tuner.stats.row()}")

    print("\n== serve: two ladder depths through the Session ==")
    # a second net at the OTHER ladder depth, sharing the same server
    if args.deep:
        n_hidden_b = 96 if args.fast else 256
    else:
        n_hidden_b = (96, 48) if args.fast else (256, 96)
    cfg_b = mlp.MLPConfig(n_hidden=n_hidden_b, epochs=max(epochs // 2, 8),
                          lr=2.0, seed=43)
    params_b = mlp.train(cfg_b, xtr, ytr, device=dev)
    qnet_b = quantize.quantize(params_b)

    server = netgen.NetServer(session=session, slot_capacity=256)
    t0 = time.perf_counter()
    server.register("ladder-a", qnet)           # memory hit: compiled above
    server.register("ladder-b", qnet_b)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.compile(qnet, target="torch")       # same weights -> cache hit
    warm = time.perf_counter() - t0
    print(f"  register (2 versions, warmed): {cold*1e3:.0f} ms; "
          f"warm predictor acquisition: {warm*1e6:.0f} us")

    # a same-topology variant (coarser weight quantization) to show the
    # stacked multi-net dispatch; the deeper net routes via fallback
    qnet_v2 = quantize.QuantizedNet(weights=[
        quantize.int_cast_weights(w, bound=5)
        for w in quantize.param_weights(params)])
    server.register("ladder-a-b5", qnet_v2)
    out = server.predict_many(                       # one stacked dispatch
        {"ladder-a": xte[:512], "ladder-a-b5": xte[:512]})
    out.update(server.predict_many(                  # other depth: routed alone
        {"ladder-b": xte[:512]}))
    for version in ("ladder-a", "ladder-a-b5", "ladder-b"):
        acc = float(np.mean(out[version] == yte[:512]))
        print(f"  {version:12s} acc={acc:.1%} ({len(out[version])} preds)")
    print(f"  dispatch: {server.dispatch_counts}  |  {session.stats().row()}")
    if session.store is not None:
        print(f"  {session.store.stats.row()}  "
              f"({len(session.store.keys())} artifacts on disk)")

    print("\n== online serving: single requests, continuous slot batching ==")
    n_online = 64 if args.fast else 256
    with netgen.ServingEngine(server, max_batch_delay=0.002,
                              max_queue_depth=4096) as eng:
        futs = [(i, eng.submit("ladder-a" if i % 2 else "ladder-b", x))
                for i, x in enumerate(xte[:n_online])]
        online = np.array([f.result(timeout=30) for _, f in futs])
        acc = float(np.mean(online == yte[:n_online]))
        st = eng.stats()
    print(f"  {st.row()}")
    print(f"  acc={acc:.1%} over {n_online} single-request submits "
          f"({st.batches} dispatches — continuous batching amortized "
          f"{n_online}/{st.batches} requests per round)")

    if args.trace:
        trace_dir = Path(args.trace)
        trace_dir.mkdir(parents=True, exist_ok=True)
        n = telemetry.export_jsonl(trace_dir / "trace.jsonl")
        (trace_dir / "metrics.prom").write_text(telemetry.prometheus())
        print(f"\n== telemetry ({n} spans -> {trace_dir}/trace.jsonl) ==")
        print(telemetry.report())


if __name__ == "__main__":
    main()
