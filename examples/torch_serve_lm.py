"""Batched LM serving on the port: prefill + decode with the serving
engine, plus the paper's technique applied to the checkpoint (int8 weight
specialization) with its quality and size deltas.

The port's counterpart of `examples/serve_lm.py`, on the reduced
qwen1.5-4b (2 layers, d_model 64, vocab 512). Runs on the card unless
`--device cpu` is given:

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.data.pipeline import make_batch
from repro_torch.models import api, base
from repro_torch.quantized import apply as qapply
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.smoke("qwen1.5-4b")
    params = base.tree_init(api.abstract_params(cfg),
                            torch.Generator(device=dev).manual_seed(0), dev)

    print("== batched generation ==")
    eng = Engine(cfg, params, ServeConfig(max_len=128, max_new_tokens=16), device=dev)
    prompts = (np.arange(32, dtype=np.int32).reshape(8, 4) * 13) % cfg.vocab
    t0 = time.time()
    out = eng.generate(prompts)
    dt = time.time() - t0
    print(f"batch={prompts.shape[0]} prompt_len={prompts.shape[1]} "
          f"new_tokens={out.shape[1]} -> {out.size / dt:.1f} tok/s ({dev.type}, host clock)")
    print("sample:", out[0].tolist())

    print("\n== paper technique on the LM checkpoint (W8 specialization) ==")
    shape = base.ShapeConfig("eval", 64, 4, "train")
    batch = {k: torch.as_tensor(v, device=dev).long()
             for k, v in make_batch(cfg, shape, 0).items()}
    with torch.inference_mode():
        loss_fp, _ = api.loss_fn(cfg, params, batch)
        qt, stats = qapply.quantize_tree(params, min_size=0)
        loss_q, _ = api.loss_fn(cfg, qapply.dequantize_tree(qt), batch)
    loss_fp, loss_q = float(loss_fp), float(loss_q)
    print(f"storage: {stats['bytes_before'] / 1e6:.2f} MB -> "
          f"{stats['bytes_after'] / 1e6:.2f} MB "
          f"({stats['compression']:.2f}x, {stats['n_quantized']} tensors)")
    print(f"loss: fp32={loss_fp:.4f}  int8-weights={loss_q:.4f} "
          f"(delta {abs(loss_q - loss_fp) / loss_fp:.2%})")
    ps = qapply.prune_stats(params)
    print(f"structurally dead channels: {ps['dead_fraction']:.2%} "
          "(netgen would delete these at specialization)")


if __name__ == "__main__":
    main()
