"""LM serving launcher of the port.

  python -m repro_torch.launch.serve --arch qwen1.5-4b [--smoke] \
      [--batch 8] [--prompt-len 16] [--new-tokens 16] [--w8] [--multi-pod] [--device cuda]

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen1.5-4b --smoke \
      --device cpu

Counterpart of `repro/launch/serve.py`, for every config the port
registers (`configs.ARCHS`: qwen1.5-4b, gemma-2b,
llama3.2-3b, qwen2-72b, granite-moe-1b-a400m, qwen3-moe-30b-a3b,
mamba2-2.7b, zamba2-2.7b; and the port-only `configs.PORT_ONLY`:
zamba2-7b-instruct, which serves on one process only). Without --smoke the full published config is
served; weights are random, seeded 0 and drawn on the device by
`models.base.tree_draw`: a layer slice at a time, each slice from its own
seeded generator, so no fp32 temporary exceeds one layer slice or one
unstacked leaf. --w8 serves the int8 checkpoint (`serving_leaf`, every
matmul weight; a stacked leaf quantized a slice at a time, which gives
the whole tree's `q` and `s` bit for bit, each slice whole before any
split); a MoE model raises there, as the reference's W8 MoE fails
(`layers/moe.py`). In fp32 qwen3-moe-30b-a3b (122 GB) and qwen2-72b
(291 GB) fit no one card: split them over enough ranks, or use --smoke.

One process serves on one card (or the CPU) with no mesh. Under
`torchrun` (`WORLD_SIZE` above 1) every process joins the world (NCCL on
the card, gloo with --device cpu) and serves under a mesh
(`mesh_and_rules`), with the reference's TP-only serving rules
(`tensor.serving_rules`: parameters replicated over the data axes):

* --multi-pod: the reference's 2 x 16 x 16 production mesh, the batch
  over ("pod", "data"); on a world of any other size than 512 it raises
  the mesh's own error, as the training launcher does;
* off --smoke on a world of exactly 256 ranks: the reference's 16 x 16
  production mesh, the batch over "data";
* every other world: `make_host_mesh(model=world)`, the port's own
  branch for a few cards (ROADMAP.md, C): all ranks on "model".

Every family is split over the model axis (ROADMAP.md A.7a, A.7c, A.7d:
the dense layers' heads, ffn and vocab, the KV cache by kv heads or by
positions; each Mamba2 mixer by heads, zamba2's shared block as a dense
layer; each MoE block's experts E/m a rank), a W8 checkpoint's `q` and
scales with it (A.7e), and `Engine` serves each rank its rows of the
batch over the data axes, every rank returning the whole batch's tokens.
Every rank draws the tree from the same seed a layer slice at a time and
keeps only its shards of each slice (`tensor.draw_keep`; under --w8 each
slice quantized whole first), so a rank holds its shards' bytes and one
fp32 slice, never a whole stacked leaf: qwen2-72b needs about 291 GB / m a rank
in fp32 under a model axis of m, plus one slice.
Rank 0 prints the same summary line as the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api, base
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.quantized import apply as qapply
from repro_torch.serve.engine import Engine, ServeConfig


PRODUCTION_WORLD = 256       # the single-pod production mesh's ranks


def mesh_and_rules(args, world: int, device=None) -> tuple:
    """(mesh, rules) the launcher serves under, from its arguments and
    the world's size: (None, None) for one process without --multi-pod."""
    if args.multi_pod:
        mesh = make_production_mesh(multi_pod=True, device=device)
    elif world == 1:
        return None, None
    elif not args.smoke and world == PRODUCTION_WORLD:
        mesh = make_production_mesh(device=device)
    else:
        mesh = make_host_mesh(model=world, device=device)
    return mesh, tensor.serving_rules(mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--w8", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
    lead = True
    try:
        mesh, rules = mesh_and_rules(args, world, dev)
        if mesh is not None:
            dev = resolve_device(dev.type)          # the rank's card, set by the mesh
            lead = dist.get_rank() == 0
        with shd.use_mesh(mesh, rules) if mesh else contextlib.nullcontext():
            out, dt = _serve(cfg, args, dev)
    finally:
        if world > 1:
            dist.destroy_process_group()
    if lead:
        print(f"generated {out.size} tokens in {dt:.2f}s "
              f"({out.size/dt:.1f} tok/s); sample: {out[0][:12].tolist()}")
    return out


def draw_params(cfg, dev, w8: bool = False) -> dict:
    """The launcher's weights: `api.abstract_params(cfg)` drawn by
    `base.tree_draw` from seed 0 on `dev`, under --w8 each drawn part
    quantized whole (`serving_leaf`: a stacked leaf a slice at a time),
    then cut to this rank's shards under the active mesh
    (`tensor.draw_keep`)."""
    cut = tensor.draw_keep(cfg)

    def quantized(path, info, part, i):
        part = qapply.serving_leaf(base.keystr(path), part, shape=info.shape, min_size=0)
        return part if cut is None else cut(path, info, part, i)

    with torch.inference_mode():
        return base.tree_draw(api.abstract_params(cfg), 0, dev, keep=quantized if w8 else cut)


def _serve(cfg, args, dev):
    params = draw_params(cfg, dev, args.w8)
    if args.w8:
        print("serving W8-specialized checkpoint (paper technique)")
    eng = Engine(cfg, params, ServeConfig(
        max_len=args.prompt_len + args.new_tokens + 8,
        max_new_tokens=args.new_tokens), device=dev)
    del params
    prompts = (np.arange(args.batch * args.prompt_len, dtype=np.int32)
               .reshape(args.batch, args.prompt_len) * 17) % cfg.vocab
    t0 = time.time()
    out = eng.generate(prompts)
    return out, time.time() - t0


if __name__ == "__main__":
    main()
