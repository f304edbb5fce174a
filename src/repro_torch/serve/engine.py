"""Batched LM serving engine: prefill + decode loop over a shared cache.

Counterpart of `repro/serve/engine.py`. The engine serves fixed-size
batches of prompts: prefill once, then one greedy token per step for the
whole batch (`serve_step`). Greedy decoding is all the reference does:
`ServeConfig` carries its `temperature` and `seed` fields, in its order
and with its defaults, and, as there, nothing reads them. It runs
on `device` (the card unless the caller names the CPU). On the card, a
Mamba2 or zamba2 prefill sends every SSD through the `ssd_scan` kernel;
`use_kernel=False` exists only so that tests and `chip_smoke.py` can
compare the two routes, and nothing switches to it on a failure. The
dense and MoE families reach no kernel and ignore the flag.

Under an active mesh whose model axis is above 1 (`sharding.use_mesh`,
around both the construction and `generate`, as the reference's launcher
does), a model of any family serves split (`parallel/tensor.py`):
the engine keeps this rank's parameter shards (`shard_params`, from
whole leaves or shards; a Mamba2 mixer's by heads, a MoE block's experts
E/m a rank) and builds its cache
at its shards' shapes (`local_tree`), its length rounded up to a
multiple of the axis where a KV cache goes by positions (`cache_len`).
Each rank's prefill sends its mixers' SSDs, on its heads, through the
`ssd_scan` kernel. A W8 checkpoint (`quantize_params_for_serving` of the
whole tree) is cut the same way, its scales with it (ROADMAP.md A.7e).

Under an active mesh whose batch rule ("data", or ("pod", "data") on a
mesh with a "pod" axis, `tensor.serving_rules`) spans n ranks above 1,
every rank is handed the whole batch and serves its B / n rows
(`data_parallel.local_rows`' order: rank order over the data group, the
same rows on every rank of a model group), its modality extras cut by
rows too, from a cache of those rows; prefill and decode run inside
`data_parallel.reducing` over the data group, so a MoE layer's capacity
and expert queues are the global batch's. Each step's tokens are
gathered over the data group, and every rank returns the same (B, new)
array, as the reference returns its global one; `eos_id` masks the
gathered tokens. A batch that the data axes do not divide is served
whole on every rank, recorded in `sharding.fallbacks()` as the
reference's spec records it (a prefix of the axes where one divides).

Spans (`netgen.telemetry`, live only while traced): each call is a
`serve.generate` (rows: this rank's, length, new) rooting its own trace,
over `serve.cache_init` (the cache drawn for the call: bytes),
`serve.prefill` and one `serve.decode_step` (step) a new token, the
stretches over which `stats` is taken; `serve.sync` is each gather and
copy of the tokens to the host. The cache's and the prefill's spans (and
those inside the prefill) record device seconds; a decode step's spans
stamp the host clock alone, so a traced step is not slowed by events.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.models import api
from repro_torch.models.base import ArchConfig, tree_init, tree_items, tree_map
from repro_torch.netgen.telemetry import device_span, span
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor

__all__ = ["ServeConfig", "make_serve_step", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    max_new_tokens: int = 32
    temperature: float = 0.0      # unread: decoding is greedy, as in the reference
    eos_id: int = -1              # -1 => never stop early
    seed: int = 0                 # unread, as in the reference


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens(B,1), pos(B,)) -> (next (B,1), cache).
    Greedy argmax inside the step (the first maximum wins)."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = api.decode_step(cfg, params, tokens, pos, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return serve_step


class Engine:
    """`generate` serves a batch of prompts. `stats` holds the host-clock
    seconds of the last call's prefill (through its first token on the
    host) and of each decode step."""

    def __init__(self, cfg: ArchConfig, params, sc: ServeConfig, *, device=None,
                 use_kernel: bool = True):
        self.device = resolve_device(device)
        self.cfg, self.sc, self.use_kernel = cfg, sc, use_kernel
        self.params = tensor.shard_params(cfg, tree_map(lambda t: t.to(self.device), params))
        self._step = make_serve_step(cfg)
        self.stats: dict = {}

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, extras: dict | None = None) -> np.ndarray:
        """prompts: (B, P) int32 token ids (uniform length); `extras` the
        prompt's modality inputs (`pixel_embeds`/`pixel_mask`/`positions`
        for vlm, `frame_embeds` for audio), numpy arrays or tensors, moved
        to the engine's device with their dtypes. Returns
        (B, max_new_tokens) int32, every row, on every rank."""
        B, P = prompts.shape
        sc, dev = self.sc, self.device
        with span("serve.generate", length=P, new=sc.max_new_tokens) as call:
            batch = {"tokens": torch.as_tensor(np.asarray(prompts), device=dev).long()}
            if extras:
                batch.update({k: torch.as_tensor(v).to(dev) for k, v in extras.items()})
            group = _data_group(B)
            if group is not None:
                batch = dp.local_rows(batch, 1, dist.get_world_size(group),
                                      dist.get_rank(group))
            rows = batch["tokens"].shape[0]
            call.set_attr("rows", rows)
            with device_span("serve.cache_init") as sp:
                cache_info = api.abstract_cache(self.cfg, rows,
                                                tensor.cache_len(self.cfg, sc.max_len))
                cache = tree_init(tensor.local_tree(self.cfg, cache_info),
                                  torch.Generator(device=dev).manual_seed(0), dev)
                sp.set_attr("bytes", sum(t.nbytes for _, t in tree_items(cache)))

            def gathered(toks):
                with span("serve.sync"):
                    return (toks if group is None
                            else tensor.all_gather(toks, group, dim=0)).cpu().numpy()

            with dp.reducing(group):
                with device_span("serve.prefill"):
                    t0 = time.perf_counter()
                    logits, cache = api.prefill(self.cfg, self.params, batch, cache,
                                                use_kernel=self.use_kernel)
                    toks = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                    out = [gathered(toks)]
                    self.stats = {"prefill_s": time.perf_counter() - t0, "decode_s": []}
                pos = torch.full((rows,), P, dtype=torch.int32, device=dev)
                alive = np.ones((B,), bool)
                for step in range(sc.max_new_tokens - 1):
                    with span("serve.decode_step", step=step):
                        t0 = time.perf_counter()
                        toks, cache = self._step(self.params, cache, toks.long(), pos)
                        pos = pos + 1
                        t_np = gathered(toks)
                        self.stats["decode_s"].append(time.perf_counter() - t0)
                    if sc.eos_id >= 0:
                        alive &= (t_np[:, 0] != sc.eos_id)
                        t_np = np.where(alive[:, None], t_np, sc.eos_id)
                    out.append(t_np)
        return np.concatenate(out, axis=1)


def _data_group(batch: int):
    """The group a batch of `batch` rows is split over under the active
    mesh: its "batch" rule's axes, or the prefix of them that divides it
    (the reference's spec, whose fallback is recorded); None without a
    mesh or where that is one rank."""
    mesh = shd.active_mesh()
    if mesh is None:
        return None
    part = shd.spec((batch,), ("batch",))
    names = () if not part else (part[0],) if isinstance(part[0], str) else tuple(part[0])
    return mesh.group(names) if mesh.size(names) > 1 else None
