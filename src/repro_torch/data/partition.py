"""Heterogeneous FL partitioners (numpy copies of the reference's).

``partition_label_skew`` reproduces the paper's §VI-A protocol: each client
draws samples from at most ``classes_per_client`` labels (2 for FMNIST,
6 for CIFAR-10). ``partition_dirichlet`` is the common Dir(alpha)
alternative used in ablations.

Every client receives exactly ``per_client`` samples (the paper assumes
equal-size local datasets).
"""

from __future__ import annotations

import numpy as np


def partition_label_skew(
    y: np.ndarray,
    n_clients: int,
    classes_per_client: int,
    per_client: int,
    seed: int = 0,
) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    by_class = {c: np.where(y == c)[0] for c in classes}
    out = []
    for _ in range(n_clients):
        cs = rng.choice(classes, size=classes_per_client, replace=False)
        pool = np.concatenate([by_class[c] for c in cs])
        idx = rng.choice(pool, size=per_client, replace=pool.size < per_client)
        out.append(np.sort(idx))
    return out


def partition_dirichlet(
    y: np.ndarray,
    n_clients: int,
    per_client: int,
    alpha: float = 0.3,
    seed: int = 0,
) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    by_class = {c: np.where(y == c)[0] for c in classes}
    out = []
    for _ in range(n_clients):
        p = rng.dirichlet(np.full(len(classes), alpha))
        counts = rng.multinomial(per_client, p)
        idx = np.concatenate(
            [
                rng.choice(by_class[c], size=k, replace=k > by_class[c].size)
                for c, k in zip(classes, counts)
                if k > 0
            ]
        )
        out.append(np.sort(idx))
    return out
