"""Training launcher of the port.

  python -m repro_torch.launch.train --arch llama3.2-3b [--shape train_4k] \
      [--smoke] [--steps N] [--resume] [--ckpt-dir DIR] [--lr LR] [--device cuda]

Counterpart of `repro/launch/train.py` on one card. --smoke trains the
reduced same-family config at 4 x 64 tokens a step without remat;
without it, the full published config at `--shape` (`models.base.SHAPES`)
with remat. The trainer checkpoints every 25 steps into --ckpt-dir
(default: `repro_torch_launch_train` in the temporary directory) and
--resume continues from the latest checkpoint there. The reference's
--multi-pod mesh has no counterpart yet (ROADMAP.md, A.7): it raises.
Prints the reference's summary line.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.models.base import SHAPES, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError("--multi-pod needs the port's meshes (ROADMAP.md, A.7: "
                                  "meshes)")

    if args.smoke:
        cfg = configs.smoke(args.arch)
        shape = ShapeConfig("smoke", seq_len=64, global_batch=4, kind="train")
    else:
        cfg = configs.get_config(args.arch)
        shape = SHAPES[args.shape]

    oc = adamw.OptConfig(lr=args.lr, total_steps=args.steps)
    tc = trainer.TrainerConfig(total_steps=args.steps, ckpt_every=25, ckpt_dir=args.ckpt_dir,
                               remat="none" if args.smoke else "full")
    state, hist = trainer.run(cfg, shape, oc, tc, resume=args.resume, device=args.device)
    if hist["loss"]:
        print(f"steps={len(hist['loss'])} "
              f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} "
              f"stragglers={len(hist['stragglers'])}")
    return hist


if __name__ == "__main__":
    main()
