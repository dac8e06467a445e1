"""Named SeedSequence spawn-key streams — the port's copy of the reference
RNG registry (``repro.core.rng``), kept numerically identical.

Every host-side random draw hangs off ``SeedSequence(seed, spawn_key=(kind,
*steps))`` with a *named* kind, so each consumer owns an independent stream
keyed by (seed, kind, step...). Two invariants fall out of this, and the
analysis suite (REP001/REP002) enforces them:

* **No shared roots.** ``default_rng(seed)`` and ``SeedSequence(seed)``
  collapse onto the same root stream for every caller handed the same
  config seed — the dataset generator, the Dirichlet partitioner and the
  capability hardware-tier draw would all consume that one root stream.
* **No arithmetic seeds.** ``seed*CONST + t`` collides across (seed, t)
  pairs; the kinds below are the registry that keeps streams apart.

The kind numbers and derivations are the reference's, unchanged: the port
draws byte-identical participants, batches, partitions and capability
snapshots for the same seed, which is what makes end-to-end comparison
with the JAX package possible.
"""
from __future__ import annotations

import numpy as np

KIND_CAP_EPOCH = 0      # capability work-mode redraw, per epoch
KIND_CAP_ROUND = 1      # capability bandwidth draw, per round
KIND_SAMPLING = 2       # round participant + batch-index draw
KIND_SR_SCATTER = 3     # stochastic-rounding scatter, per (round, chunk)
KIND_CAP_TIER = 4       # persistent hardware tier, drawn once
KIND_DATASET = 5        # synthetic dataset generation / token streams
KIND_PARTITION = 6      # Dirichlet non-IID partition
# wire-boundary fault engine: step 0 = the once-per-run Byzantine
# membership draw; step (t,) = round t's dropout/straggler/corruption
# draws; step (t, client) = per-client attack noise / bit-flip positions.
KIND_FAULTS = 7


def sequence(seed: int, kind: int, *steps: int) -> np.random.SeedSequence:
    """The (seed, kind, *steps) SeedSequence — stateless spawn-tree node."""
    return np.random.SeedSequence(seed, spawn_key=(kind, *steps))


def stream(seed: int, kind: int, *steps: int) -> np.random.Generator:
    """An independent Generator for the (seed, kind, *steps) stream."""
    return np.random.default_rng(sequence(seed, kind, *steps))
