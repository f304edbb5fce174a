"""Quickstart on the PyTorch/CUDA port: the paper's pipeline end to end.

The counterpart of `examples/quickstart.py`, importing only
`repro_torch`. Trains the 784-500-10 classifier on the card, walks the
optimization ladder (sigmoid -> step -> binary input -> integer
weights), then "generates hardware": a clockless Verilog module in the
paper's Figure-6 style, and the card's specialized predictors (`torch`,
and the `cuda` kernel chain), checked to be exact rewrites of L3.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import netgen, quantize
from repro_torch.core.ladder import run_ladder


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    ap.add_argument("--verilog-out", default="/tmp/nn_inference_3x3.v")
    args = ap.parse_args()

    print("== paper ladder (reduced size for speed) ==")
    r = run_ladder(n_train=600, n_test=400, epochs=30, seed=0,
                   backends=("torch", "cuda"), device=args.device)
    print(r.table())
    print(f"\nL4/L5 exact rewrites of L3: {r.exact_l4_l5}")
    print(f"zero weights pruned at generation: {r.stats.zero_fraction:.1%}")
    print(f"multiplies after addend rewrite:  {r.stats.mults_addend}")

    print("\n== hardware generation (paper Figure 6 artifact) ==")
    rng = np.random.default_rng(0)
    demo = quantize.QuantizedNet(
        w1=rng.integers(-9, 10, size=(3, 3)).astype(np.int32),
        w2=rng.integers(-9, 10, size=(3, 3)).astype(np.int32))
    verilog = netgen.emit_verilog(demo, addend=True)
    print(verilog)
    with open(args.verilog_out, "w") as f:
        f.write(verilog)
    print(f"[written to {args.verilog_out}]")


if __name__ == "__main__":
    main()
