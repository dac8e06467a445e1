"""Synthetic datasets with the paper's shapes/cardinalities (no network access).

Classification sets are Gaussian class-prototype mixtures — learnable signal
with controllable difficulty, so relative traffic/accuracy comparisons between
FL schemes are meaningful. Token streams feed the Track-B LM archs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import rng as RNG


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_classes(self) -> int:
        return int(self.y_train.max()) + 1


def _proto_mixture(n_train, n_test, shape, n_classes, seed, noise=1.0,
                   sep=2.0):
    # own spawn-key stream: the raw seed is shared with the partitioner and
    # the capability model, so a root default_rng(seed) here would replay
    # the exact uniforms the other consumers draw (REP001)
    rng = RNG.stream(seed, RNG.KIND_DATASET)
    dim = int(np.prod(shape))
    protos = rng.normal(size=(n_classes, dim)) * sep / np.sqrt(dim)

    def make(n):
        y = rng.integers(0, n_classes, n)
        x = protos[y] + rng.normal(size=(n, dim)) * noise / np.sqrt(dim)
        return x.reshape((n,) + shape).astype(np.float32), y.astype(np.int32)

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


def cifar10_like(seed=0, scale=1.0, sep=1.1, noise=3.0) -> Dataset:
    """CIFAR-10 shapes: 50k/10k 32×32×3, 10 classes."""
    n_tr, n_te = int(50000 * scale), int(10000 * scale)
    x, y, xt, yt = _proto_mixture(n_tr, n_te, (32, 32, 3), 10, seed,
                                  sep=sep, noise=noise)
    return Dataset("cifar10", x, y, xt, yt)


def har_like(seed=1, scale=1.0, sep=1.05, noise=3.5) -> Dataset:
    """HAR: 7352/2947 samples, 9-channel×128 windows, 6 classes."""
    n_tr, n_te = int(7352 * scale), int(2947 * scale)
    x, y, xt, yt = _proto_mixture(n_tr, n_te, (128, 9), 6, seed,
                                  sep=sep, noise=noise)
    return Dataset("har", x, y, xt, yt)


def speech_like(seed=2, scale=1.0) -> Dataset:
    """Google Speech: 85511/4890 1-D clips (4000 samples), 35 classes."""
    n_tr, n_te = int(85511 * scale), int(4890 * scale)
    x, y, xt, yt = _proto_mixture(n_tr, n_te, (4000, 1), 35, seed, sep=2.2,
                                  noise=4.0)
    return Dataset("speech", x, y, xt, yt)


def oppo_ts_like(seed=3, scale=1.0, n_features=1024) -> Dataset:
    """OPPO-TS CTR: ~90k/10k samples, LR over sparse features (reduced dim),
    binary labels. (The paper's LR has 129,314 features; we keep the model
    family and shrink the feature space for the CPU simulator.)"""
    n_tr, n_te = int(90000 * scale), int(10000 * scale)
    x, y, xt, yt = _proto_mixture(n_tr, n_te, (n_features,), 2, seed, sep=0.35,
                                  noise=2.0)
    return Dataset("oppo_ts", x, y, xt, yt)


DATASETS = {"cifar10": cifar10_like, "har": har_like, "speech": speech_like,
            "oppo_ts": oppo_ts_like}


# --- Track-B token streams --------------------------------------------------

def token_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    rs = np.random.default_rng(rng)   # passthrough for an existing Generator
    toks = rs.integers(0, vocab, (batch, seq), dtype=np.int32)
    return {"tokens": toks, "labels": toks.copy()}
