"""How far a MoE prefill in bf16 compute lands from the same prefill in
fp32 compute, on the same bf16 serving copy, on the CPU: the readings
that fix `chip_smoke.py`'s MOE_BIG_BF16_RTOL before the card runs it.

    PYTHONPATH=src python scripts/moe_bf16_gap.py --arch qwen3-moe-30b-a3b --smoke --seeds 9
    PYTHONPATH=src python scripts/moe_bf16_gap.py --arch qwen3-moe-30b-a3b --layers 2

The weights are `base.tree_draw` of `base.serving_copy` (bf16), as the
card phase draws them; --layers cuts the published config's depth and
keeps its width (2 layers of qwen3-moe-30b-a3b: ~3.7 GB of bf16, ~10 GB
at the peak of the fp32-compute prefill). For each seed it prints
`chip_smoke._moe_bf16_gap`: the bf16 last logits' max |diff| as a share
of the fp32 ones' largest |logit|, the (token, layer) routings that
differ, and the shares of routed pairs dropped.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import api, base  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=chip_smoke.MOE_BIG)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--batch", type=int, default=chip_smoke.DENSE_BATCH)
    ap.add_argument("--prompt", type=int, default=chip_smoke.DENSE_PROMPT)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tree = base.serving_copy(api.abstract_params(cfg), torch.bfloat16)
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        with torch.inference_mode():
            params = base.tree_draw(tree, seed, "cpu")
        rng = np.random.default_rng(seed)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(args.batch, args.prompt))).long()
        gap = chip_smoke._moe_bf16_gap(cfg, params, tokens, "cpu")
        del params
        print(f"{cfg.name} layers {cfg.n_layers} d_model {cfg.d_model} experts {cfg.n_experts} "
              f"seed {seed} {args.batch}x{args.prompt}: bf16 vs fp32 last logits "
              f"{gap['rel_max']:.4f} of the largest |logit|; {gap['routings_differ']} of "
              f"{gap['routings']} routings differ; dropped {gap['dropped']['float32']:.4f} / "
              f"{gap['dropped']['bfloat16']:.4f}; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
