"""The check of what the timed path served, against the plain reference.

After the window has closed and the program's state is freed, a seeded
sample of the requests the window finished (`Traffic.check_sample`, the
longest prompts always in it) is run through the configuration's
reference module (`ref`, found by its name) once each: the prompt
followed by the tokens the program served but the last, so that the
reference's logits at the last `new_tokens` positions are the
distributions from which each served token was drawn greedily.

The number compared, `gap`, is the widest gap by which a served token's
reference logit lies below the reference's best logit at its position,
in units of the standard deviation of the reference's logits there (a
scale that is the same at every position and seed of a configuration).
A token the reference would also pick reads 0; a near tie decided the
other way by rounding reads a little above 0; a wrong token reads
several units. A gap that is not finite (the reference's logits NaN, or
all equal) reads as infinite, so it fails every limit.

The control (`control_gap`) reads the same number for the token that
the reference computed in fp8 puts first at each position of the same
prompts and served tokens. It is not run by the benchmark's own runs.

Rows run in blocks of at most `BLOCK_TOKENS` positions.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BLOCK_TOKENS", "gaps", "served_gap", "control_gap"]

BLOCK_TOKENS = 16384


def _blocks(sample: list, prompts: dict, served: dict, new: int):
    """(tokens (R, P + new - 1) int64, served (R, new)) blocks of
    requests of one length, at most BLOCK_TOKENS positions a block."""
    by_len: dict = {}
    for b, r, length in sample:
        by_len.setdefault(length, []).append((b, r))
    for length, reqs in sorted(by_len.items()):
        per = max(1, BLOCK_TOKENS // (length + new))
        for i in range(0, len(reqs), per):
            part = reqs[i:i + per]
            toks = torch.stack([torch.as_tensor(prompts[b][r]).long() for b, r in part])
            out = torch.stack([torch.as_tensor(served[b][r]).long() for b, r in part])
            yield torch.cat([toks, out[:, :-1]], dim=1), out


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(max − logit of the chosen token) / std, at every position.
    ref_logits (R, new, V) float32; chosen (R, new) int64."""
    best = ref_logits.amax(dim=-1)
    got = torch.take_along_dim(ref_logits, chosen[..., None], dim=-1)[..., 0]
    return (best - got) / ref_logits.std(dim=-1)


def _widest(blocks) -> float:
    """The largest of the blocks' gaps; infinite once one is not finite."""
    worst = 0.0
    for g in blocks:
        v = g.max().item()
        if not math.isfinite(v):
            return math.inf
        worst = max(worst, v)
    return worst


def served_gap(ref, arch: dict, weights: dict, sample: list, prompts: dict, served: dict,
               new: int, device) -> float:
    """The widest gap of the program's served tokens over the sample."""
    return _widest(gaps(ref.logits(arch, weights, toks.to(device), new), out.to(device))
                   for toks, out in _blocks(sample, prompts, served, new))


def control_gap(ref, arch: dict, weights: dict, sample: list, prompts: dict, served: dict,
                new: int, device) -> float:
    """The widest gap of the fp8 reference's first choices over the same
    prompts and served tokens."""
    def block(toks):
        toks = toks.to(device)
        low = ref.logits(arch, weights, toks, new, precision="fp8")
        return gaps(ref.logits(arch, weights, toks, new), low.argmax(dim=-1))
    return _widest(block(toks) for toks, _ in _blocks(sample, prompts, served, new))
