"""The one generator of traffic: a closed loop of batches, read from a
traffic file's parameters.

A traffic file (`traffic/<name>.json`) holds:

- `loop`: "closed", `clients`: 1 (one client sends a batch and waits
  for it);
- `rows`: requests in a batch;
- `prompt_lengths`: the multiset of prompt lengths of one cycle; each
  batch has one length, and every cycle sends each entry once, in an
  order shuffled by the seed, so every seed sends the same work;
- `new_tokens`: tokens generated for every request (greedy, no early
  stop);
- `check_requests`: how many of the window's requests the check of the
  outputs compares, spread evenly over the lengths.

Token ids are uniform over the vocabulary. Batch `i`'s prompts, the
cycles' orders and the warm-up prompts each come from their own numpy
generator, seeded from (`--seed`, a stream name, the index), so the same
seed gives the same inputs in every run, and no batch depends on how
many came before it in time.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["Traffic"]


class Traffic:
    def __init__(self, spec: dict, vocab: int, seed: int):
        if spec.get("loop") != "closed" or spec.get("clients", 1) != 1:
            raise ValueError(f"traffic {spec}: only a closed loop of one client is generated")
        self.rows = int(spec["rows"])
        self.lengths = [int(x) for x in spec["prompt_lengths"]]
        self.new_tokens = int(spec["new_tokens"])
        self.check_requests = int(spec["check_requests"])
        self.vocab = vocab
        self.seed = seed % 2 ** 64
        if self.rows < 1 or not self.lengths or min(self.lengths) < 1 or self.new_tokens < 1:
            raise ValueError(f"bad traffic parameters {spec}")

    def _rng(self, stream: str, i: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, zlib.crc32(stream.encode()), i])

    @property
    def max_len(self) -> int:
        """The longest prompt plus its answer: what a cache must hold."""
        return max(self.lengths) + self.new_tokens

    def cycle_lengths(self, cycle: int) -> list[int]:
        """The prompt length of each batch of one cycle, in its order."""
        order = self._rng("order", cycle).permutation(len(self.lengths))
        return [self.lengths[j] for j in order]

    def prompts(self, stream: str, i: int, length: int) -> np.ndarray:
        """(rows, length) int32 token ids of batch i of a stream."""
        return self._rng(stream, i).integers(0, self.vocab, size=(self.rows, length),
                                             dtype=np.int32)

    def warm_prompts(self) -> list[np.ndarray]:
        """One batch of each distinct prompt length, for set-up."""
        return [self.prompts("warm", j, length)
                for j, length in enumerate(sorted(set(self.lengths)))]

    def check_sample(self, requests: list[tuple[int, int, int]]) -> list[tuple[int, int, int]]:
        """A seeded sample of (batch, row, length) requests: about
        `check_requests` of them, as many of each length, so the longest
        prompts are always in it."""
        by_len: dict[int, list] = {}
        for r in requests:
            by_len.setdefault(r[2], []).append(r)
        each = -(-self.check_requests // len(by_len))
        rng = self._rng("check", 0)
        out = []
        for length in sorted(by_len):
            pool = by_len[length]
            pick = rng.choice(len(pool), size=min(each, len(pool)), replace=False)
            out.extend(pool[j] for j in sorted(pick))
        return out
