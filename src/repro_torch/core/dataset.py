"""Synthetic MNIST-like digit dataset.

The paper evaluates on MNIST (28x28 grayscale handwritten digits, pixel
values 0..255). MNIST does not ship with the repository, so we
procedurally render a drop-in replacement: digit glyphs from a 5x7 bitmap
font, upscaled to 28x28 with random translation, scale, stroke thickness,
and pixel noise. The resulting arrays have the exact MNIST interface the
paper's pipeline expects: uint8 images in [0, 255], integer labels 0..9.

Deterministic given a seed, so every experiment is reproducible. A copy
of `repro/core/dataset.py` (numpy only), kept in the port so that it
imports nothing of the JAX package; both give the same images for a
seed.
"""
from __future__ import annotations

import numpy as np

# 5x7 bitmap font for digits 0-9 (classic hex display font).
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}

IMG = 28  # matches the paper: 28x28 input, 784 input nodes


def _glyph(digit: int) -> np.ndarray:
    rows = _FONT[digit]
    return np.array([[int(c) for c in r] for r in rows], dtype=np.float32)


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    """Render one 28x28 uint8 image with random geometry + noise."""
    g = _glyph(digit)  # (7, 5)
    # Random target glyph size (stroke scale), keep aspect roughly 7:5.
    # Narrow ranges: MNIST digits are size-normalized, and the paper's 98%
    # from 1000 training images implies an easy, well-normalized task.
    h = int(rng.integers(18, 21))
    w = int(rng.integers(12, 15))
    # Nearest-neighbour upscale.
    ri = (np.arange(h) * g.shape[0] // h)
    ci = (np.arange(w) * g.shape[1] // w)
    big = g[np.ix_(ri, ci)]
    # Random stroke thickening via max-pool style dilation.
    if rng.random() < 0.5:
        pad = np.pad(big, 1)
        big = np.maximum.reduce(
            [pad[1:-1, 1:-1], pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]]
        )
    img = np.zeros((IMG, IMG), dtype=np.float32)
    # Centered placement with small jitter (MNIST digits are centered; full
    # translation invariance would make the task much harder than MNIST).
    rc, cc = (IMG - h) // 2, (IMG - w) // 2
    r0 = int(np.clip(rc + rng.integers(-2, 3), 0, IMG - h))
    c0 = int(np.clip(cc + rng.integers(-2, 3), 0, IMG - w))
    img[r0 : r0 + h, c0 : c0 + w] = big
    # Intensity: ink pixels get high-but-varied values, paper, low noise.
    ink = rng.uniform(170, 255, size=img.shape).astype(np.float32)
    bg = np.abs(rng.normal(0.0, 18.0, size=img.shape)).astype(np.float32)
    out = np.where(img > 0.5, ink, bg)
    # Slight blur to soften edges (3x3 box, cheap).
    p = np.pad(out, 1)
    out = (
        p[1:-1, 1:-1] * 0.6
        + (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]) * 0.1
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def make_dataset(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Return (images uint8 (n, 784), labels int32 (n,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = np.stack([_render(int(d), rng).reshape(-1) for d in labels])
    return imgs, labels


def train_test_split(
    n_train: int = 1000, n_test: int = 1000, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Paper protocol: train on 1000 images; test on a disjoint set.

    Disjointness is by construction (independent random draws from the
    generative process with different seeds), matching the paper's
    train/test separation requirement.
    """
    xtr, ytr = make_dataset(n_train, seed=seed)
    xte, yte = make_dataset(n_test, seed=seed + 10_000)
    return xtr, ytr, xte, yte
