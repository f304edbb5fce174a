"""Training launcher of the port.

  python -m repro_torch.launch.train --arch llama3.2-3b [--shape train_4k] \
      [--smoke] [--steps N] [--resume] [--ckpt-dir DIR] [--lr LR] [--device cuda]

Counterpart of `repro/launch/train.py`. --smoke trains the reduced
same-family config at 4 x 64 tokens a step without remat; without it,
the full published config at `--shape` (`models.base.SHAPES`) with
remat. As in the reference, the trainer runs under a mesh: the host
mesh over whatever ranks exist (one rank, the card or the CPU, unless
a process group of several was opened before) with the batch over
"data"; --multi-pod builds the 2x16x16 production mesh, which needs a
world of 512 ranks and raises its world-size error on one card, as the
reference fails on one device. The trainer checkpoints every 25 steps
into --ckpt-dir (default: `repro_torch_launch_train` in the temporary
directory) and --resume continues from the latest checkpoint there.
Prints the reference's summary line.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.base import SHAPES, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
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

    if args.smoke:
        cfg = configs.smoke(args.arch)
        shape = ShapeConfig("smoke", seq_len=64, global_batch=4, kind="train")
    else:
        cfg = configs.get_config(args.arch)
        shape = SHAPES[args.shape]

    oc = adamw.OptConfig(lr=args.lr, total_steps=args.steps)
    tc = trainer.TrainerConfig(total_steps=args.steps, ckpt_every=25, ckpt_dir=args.ckpt_dir,
                               remat="none" if args.smoke else "full")
    rules = {"batch": ("data",)} if not args.multi_pod else {}
    opened = not dist.is_initialized()
    try:
        mesh = (make_production_mesh(multi_pod=True, device=args.device) if args.multi_pod
                else make_host_mesh(device=args.device))
        with shd.use_mesh(mesh, rules):
            _, hist = trainer.run(cfg, shape, oc, tc, resume=args.resume, device=args.device)
    finally:
        if opened and dist.is_initialized():      # the one-rank group the mesh opened
            dist.destroy_process_group()
    if hist["loss"]:
        print(f"steps={len(hist['loss'])} "
              f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} "
              f"stragglers={len(hist['stragglers'])}")
    return hist


if __name__ == "__main__":
    main()
