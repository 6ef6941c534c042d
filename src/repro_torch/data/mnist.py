"""Synthetic MNIST-like digit glyphs (generated, no downloads).

Procedurally renders 28x28 digit glyphs per class with stroke jitter,
translation and pixel noise.  Used to (a) train the paper's bias-free CNN
(Fig. 6) and (b) reproduce the per-class negative-activation / cycle-saving
statistics (Figs. 8-9) *qualitatively* — the exact percentages depend on the
true MNIST distribution.

A copy of ``repro.data.mnist``: numpy-generated, so the same seed gives the
same bytes in both packages.
"""

from __future__ import annotations

import numpy as np

_SEGS = {
    # seven-segment-ish strokes in a 20x20 box: (r0, c0, r1, c1)
    0: [(0, 2, 0, 14), (18, 2, 18, 14), (0, 2, 18, 2), (0, 14, 18, 14)],
    1: [(0, 8, 18, 8), (0, 8, 4, 4)],
    2: [(0, 2, 0, 14), (0, 14, 9, 14), (9, 2, 9, 14), (9, 2, 18, 2),
        (18, 2, 18, 14)],
    3: [(0, 2, 0, 14), (9, 4, 9, 14), (18, 2, 18, 14), (0, 14, 18, 14)],
    4: [(0, 2, 9, 2), (9, 2, 9, 14), (0, 14, 18, 14)],
    5: [(0, 2, 0, 14), (0, 2, 9, 2), (9, 2, 9, 14), (9, 14, 18, 14),
        (18, 2, 18, 14)],
    6: [(0, 2, 0, 14), (0, 2, 18, 2), (9, 2, 9, 14), (9, 14, 18, 14),
        (18, 2, 18, 14)],
    7: [(0, 2, 0, 14), (0, 14, 18, 6)],
    8: [(0, 2, 0, 14), (9, 2, 9, 14), (18, 2, 18, 14), (0, 2, 18, 2),
        (0, 14, 18, 14)],
    9: [(0, 2, 0, 14), (0, 2, 9, 2), (9, 2, 9, 14), (0, 14, 18, 14),
        (18, 2, 18, 14)],
}


def _draw(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    dr = rng.integers(1, 7)
    dc = rng.integers(1, 7)
    thick = rng.integers(1, 3)
    for (r0, c0, r1, c1) in _SEGS[digit]:
        n = max(abs(r1 - r0), abs(c1 - c0)) + 1
        rs = np.linspace(r0, r1, n).round().astype(int) + dr
        cs = np.linspace(c0, c1, n).round().astype(int) + dc
        jr = rng.integers(-1, 2)
        jc = rng.integers(-1, 2)
        for t in range(thick):
            r = np.clip(rs + jr + t, 0, 27)
            c = np.clip(cs + jc, 0, 27)
            img[r, c] = 1.0
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0)
    return img


def synth_mnist(n_per_class: int, seed: int = 0
                ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, 28, 28) float32 in [0,1], labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for d in range(10):
        for _ in range(n_per_class):
            imgs.append(_draw(d, rng))
            labels.append(d)
    order = rng.permutation(len(imgs))
    return (np.stack(imgs)[order], np.asarray(labels, np.int32)[order])
