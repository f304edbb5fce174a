"""The plain reference (`gpubench/reference/mamba2.py`) against the
port's CPU path at `configs.smoke` sizes, with the configuration file's
tied head.

The port runs here in float32 compute (`compute_dtype="float32"`), so
the two agree to float32 rounding: the reference's whole-sequence
logits against the port's prefill and then its decode steps through
the conv and SSM caches. The weights are the benchmark's own draw
(`weights.draw`), from the configuration file's init rules.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import weights
from gpubench.reference import mamba2 as ref

BENCH = Path(__file__).resolve().parents[1]
TOL = 2e-4          # float32 against float32: sums taken in another order


def _config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _smoke(name: str):
    from repro_torch import configs
    return dataclasses.replace(configs.smoke(name), compute_dtype="float32",
                               tie_embeddings=_config(name)["arch"]["tie_embeddings"])


def _arch(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items()}


def _init(name: str) -> list:
    return _config(name)["init"]


def _port_tokens_and_logits(cfg, w, prompts: np.ndarray, new: int):
    """The port's served tokens (prefill, then decode through the caches)
    and the logits that chose each."""
    from repro_torch.models import api
    from repro_torch.models.base import tree_init
    B, P = prompts.shape
    cache = tree_init(api.abstract_cache(cfg, B, P + new), torch.Generator().manual_seed(0),
                      "cpu")
    toks = torch.as_tensor(prompts).long()
    with torch.inference_mode():
        lg, cache = api.prefill(cfg, w, {"tokens": toks}, cache, use_kernel=True)
        out, logits = [], [lg.float()]
        nxt = lg.argmax(-1)[:, None]
        for i in range(new - 1):
            out.append(nxt)
            lg, cache = api.decode_step(cfg, w, nxt, torch.full((B,), P + i, dtype=torch.int32),
                                        cache)
            logits.append(lg.float())
            nxt = lg.argmax(-1)[:, None]
        out.append(nxt)
    return torch.cat(out, dim=1), torch.stack(logits, dim=1)


@pytest.mark.parametrize("name,prompt", [("mamba2-2.7b", 200), ("mamba2-2.7b", 600)])
def test_reference_matches_port_prefill_and_decode(name, prompt):
    from repro_torch.models import api
    cfg = _smoke(name)
    w = weights.draw(api.abstract_params(cfg), _init(name), 1234, "cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, prompt)).astype(np.int32)
    new = 4
    served, port_logits = _port_tokens_and_logits(cfg, w, prompts, new)
    toks = torch.cat([torch.as_tensor(prompts).long(), served[:, :-1]], dim=1)
    want = ref.logits(_arch(cfg), w, toks, new)
    scale = want.abs().max()
    assert (port_logits - want).abs().max() <= TOL * scale


def test_reference_refuses_a_family_it_does_not_compute():
    arch = dict(_config("mamba2-2.7b")["arch"], family="hybrid")
    with pytest.raises(ValueError, match="hybrid"):
        ref.logits(arch, {}, torch.zeros(1, 4, dtype=torch.long), 1)


def test_ssd_matches_a_sequential_scan():
    g = torch.Generator().manual_seed(0)
    R, T, H, P, G, N = 2, 150, 4, 8, 2, 6
    x = torch.randn(R, T, H, P, generator=g)
    dt = torch.rand(R, T, H, generator=g) * 0.5
    a = -torch.rand(H, generator=g) * 2
    b, c = torch.randn(R, T, G, N, generator=g), torch.randn(R, T, G, N, generator=g)
    y, s = ref.ssd(x, dt, a, b, c, chunk=32)
    h = torch.zeros(R, H, N, P)
    bh, ch = b.repeat_interleave(H // G, 2), c.repeat_interleave(H // G, 2)
    ys = []
    for t in range(T):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] + torch.einsum(
            "rhn,rh,rhp->rhnp", bh[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("rhn,rhnp->rhp", ch[:, t], h))
    assert torch.allclose(y, torch.stack(ys, 1), atol=1e-4, rtol=1e-4)
    assert torch.allclose(s, h, atol=1e-4, rtol=1e-4)


def test_fp8_control_rounds_and_differs():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 64, generator=g)
    r = ref.fp8_round(x, -1)
    assert not torch.equal(r, x)
    assert (r - x).abs().max() <= x.abs().amax(-1, keepdim=True).max() * 2 ** -3
