"""LM serving launcher of the port.

  python -m repro_torch.launch.serve --arch qwen1.5-4b [--smoke] \
      [--batch 8] [--prompt-len 16] [--new-tokens 16] [--w8] [--device cuda]

Counterpart of `repro/launch/serve.py` on one card (no mesh), for every
config the port registers (`configs.ARCHS`: qwen1.5-4b, gemma-2b,
llama3.2-3b, qwen2-72b, granite-moe-1b-a400m, qwen3-moe-30b-a3b,
mamba2-2.7b, zamba2-2.7b). Without --smoke the full published config is
served (qwen2-72b and qwen3-moe-30b-a3b do not fit one card in fp32: use
--smoke); weights are random from a `torch.Generator` seeded 0, made on
the device. --w8 serves the int8 checkpoint (`quantize_params_for_serving`,
every matmul weight); a MoE model raises there, as the reference's W8
MoE fails (`layers/moe.py`).
Prints the same summary line as the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.models import api, base
from repro_torch.quantized import apply as qapply
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--w8", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    dev = resolve_device(args.device)
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(0), dev)
        if args.w8:
            params = qapply.quantize_params_for_serving(cfg, params, min_size=0)
            print("serving W8-specialized checkpoint (paper technique)")
    eng = Engine(cfg, params, ServeConfig(
        max_len=args.prompt_len + args.new_tokens + 8,
        max_new_tokens=args.new_tokens), device=dev)
    prompts = (np.arange(args.batch * args.prompt_len, dtype=np.int32)
               .reshape(args.batch, args.prompt_len) * 17) % cfg.vocab
    t0 = time.time()
    out = eng.generate(prompts)
    dt = time.time() - t0
    print(f"generated {out.size} tokens in {dt:.2f}s "
          f"({out.size/dt:.1f} tok/s); sample: {out[0][:12].tolist()}")
    return out


if __name__ == "__main__":
    main()
