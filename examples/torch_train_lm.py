"""End-to-end example of the PyTorch/CUDA port: train a ~120M-parameter LM
for a few hundred steps on the synthetic pipeline, with checkpointing and
fault-tolerant resume.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--resume] \
      [--device cuda]

The counterpart of `examples/train_lm.py` through `repro_torch`: the same
llama-style dense decoder (12L x 768d, GQA 12/4, 32k vocab, ~121M
params), the same flags, and `--device` (the card unless `cpu` is named).
Checkpoints go to --ckpt-dir (default: `repro_torch_train_lm` in the
temporary directory). The loss must improve from the first ten steps to
the last ten; a run of fewer than 20 steps has no two such windows and
only reports its losses (the reference's windows overlap there, and its
check fails at --steps 2).
"""
import argparse
import os
import tempfile
import time

from repro_torch.models import api
from repro_torch.models.base import ArchConfig, ShapeConfig, count_params
from repro_torch.optim import adamw
from repro_torch.train import trainer

CFG_100M = ArchConfig(
    name="repro-120m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab=32768,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1e4,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    shape = ShapeConfig("e2e", seq_len=args.seq, global_batch=args.batch, kind="train")
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    tc = trainer.TrainerConfig(total_steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt_dir,
                               log_every=10)

    n = count_params(api.abstract_params(CFG_100M))
    print(f"model: {CFG_100M.name}, {n/1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step")

    t0 = time.time()
    state, hist = trainer.run(CFG_100M, shape, oc, tc, resume=args.resume, device=args.device)
    dt = time.time() - t0
    losses = hist["loss"]
    print(f"\ntrained {len(losses)} steps in {dt:.0f}s "
          f"({dt/max(len(losses),1):.1f}s/step)")
    if losses:
        k = min(10, len(losses))
        print(f"loss: first{k}={sum(losses[:k])/k:.4f} "
              f"last{k}={sum(losses[-k:])/k:.4f}")
        if len(losses) < 2 * k:
            print(f"{len(losses)} steps: too few for two disjoint windows of 10, not compared "
                  f"(checkpoints in {tc.ckpt_dir})")
        elif sum(losses[-k:]) < sum(losses[:k]):
            print("loss improved ✓  (checkpoints in", tc.ckpt_dir + ")")
        else:
            raise SystemExit("loss did not improve")


if __name__ == "__main__":
    main()
