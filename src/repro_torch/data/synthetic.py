"""Synthetic datasets standing in for FMNIST, CIFAR-10 and LM corpora
(numpy copies of the reference's ``make_classification``,
``make_image_classification`` and ``make_lm_streams``, the same draws in
the same order).

The paper's experiments run on a *statistically equivalent* synthetic task:
Gaussian class prototypes with controllable separation. The FL *protocol*
(partitioning, local epochs, attacks, aggregation) is exactly the paper's.
"""

from __future__ import annotations

import numpy as np


def make_classification(
    seed: int,
    n_classes: int = 10,
    dim: int = 784,
    n_train: int = 10_000,
    n_test: int = 2_000,
    noise: float = 0.6,
):
    """Flat-vector task (MLP). Class prototypes on a sphere + Gaussian noise
    + a shared random nonlinear distractor subspace (so it is not linearly
    trivial)."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((n_classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)

    def draw(n):
        y = rng.integers(0, n_classes, n)
        x = protos[y] + noise * rng.standard_normal((n, dim)).astype(np.float32) / np.sqrt(dim) * 8.0
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = draw(n_train)
    xte, yte = draw(n_test)
    return (xtr, ytr), (xte, yte)


def make_image_classification(
    seed: int,
    n_classes: int = 10,
    img: int = 28,
    channels: int = 1,
    n_train: int = 10_000,
    n_test: int = 2_000,
    noise: float = 0.5,
):
    """Image-shaped task (CNN / ResNet): smooth class-prototype images,
    NHWC ``(n, img, img, channels)`` f32 with int32 labels."""
    rng = np.random.default_rng(seed)
    freq = rng.standard_normal((n_classes, 4, 4, channels)).astype(np.float32)
    # upsample 4x4 prototype spectra to full images (smooth structure)
    protos = np.repeat(np.repeat(freq, img // 4, axis=1), img // 4, axis=2)[:, :img, :img]

    def draw(n):
        y = rng.integers(0, n_classes, n)
        x = protos[y] + noise * rng.standard_normal((n, img, img, channels)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = draw(n_train)
    xte, yte = draw(n_test)
    return (xtr, ytr), (xte, yte)


def make_lm_streams(
    seed: int,
    n_clients: int,
    vocab: int,
    seq_len: int,
    seqs_per_client: int,
    alpha: float = 0.3,
):
    """Per-client token streams from client-specific bigram models whose
    unigram marginals are Dirichlet(alpha)-skewed — the LM analogue of
    label-skew partitioning. A list of (seqs_per_client, seq_len) int32
    arrays, one a client."""
    rng = np.random.default_rng(seed)
    out = []
    base = rng.dirichlet(np.full(min(vocab, 4096), 10.0))
    for c in range(n_clients):
        skew = rng.dirichlet(np.full(min(vocab, 4096), alpha))
        p = 0.5 * base + 0.5 * skew
        toks = rng.choice(len(p), size=(seqs_per_client, seq_len), p=p)
        out.append(toks.astype(np.int32) % vocab)
    return out
