"""Dirichlet non-IID partitioner (Hsu et al. 2019), as used in the paper §6.1.

Each client's class distribution is drawn v ~ Dir(δ·q) with q the prior class
distribution. The paper's heterogeneity knob is p = 1/δ (p=0 ⇒ IID with equal
volumes; larger p ⇒ more skew, and volumes vary too).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import rng as RNG


def dirichlet_partition(labels: np.ndarray, n_clients: int, p: float,
                        seed: int = 0, min_per_client: int = 8):
    """Returns (client_indices: list[np.ndarray], label_dist [n,H], volumes [n])."""
    # the simulator hands this the same cfg.seed the dataset generator gets;
    # a root default_rng(seed) would alias that stream (REP001)
    rng = RNG.stream(seed, RNG.KIND_PARTITION)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for a in idx_by_class:
        rng.shuffle(a)

    if p <= 0:  # IID, equal volumes
        perm = rng.permutation(len(labels))
        splits = np.array_split(perm, n_clients)
    else:
        delta = 1.0 / p
        props = rng.dirichlet([delta] * n_classes, size=n_clients)  # [n, H]
        # volume skew: draw client volumes from a second Dirichlet
        vol = rng.dirichlet([max(delta, 0.2)] * n_clients)
        vol = np.maximum(vol, min_per_client / len(labels))
        vol = vol / vol.sum()
        counts = np.floor(props * (vol[:, None] * len(labels))).astype(int)
        counts = np.maximum(counts, 0)
        cursor = [0] * n_classes
        splits = []
        for i in range(n_clients):
            take = []
            for c in range(n_classes):
                avail = len(idx_by_class[c]) - cursor[c]
                k = min(counts[i, c], avail)
                take.append(idx_by_class[c][cursor[c]:cursor[c] + k])
                cursor[c] += k
            s = np.concatenate(take) if take else np.array([], int)
            if len(s) < min_per_client:   # top-up from the global pool
                extra = rng.integers(0, len(labels), min_per_client - len(s))
                s = np.concatenate([s, extra])
            rng.shuffle(s)
            splits.append(s)

    label_dist = np.zeros((n_clients, n_classes))
    volumes = np.zeros(n_clients, int)
    for i, s in enumerate(splits):
        volumes[i] = len(s)
        if len(s):
            binc = np.bincount(labels[s], minlength=n_classes)
            label_dist[i] = binc / max(len(s), 1)
    return splits, label_dist, volumes
