"""Device capability model calibrated to the paper's testbeds (§6.1).

* compute: per-sample training latency μ spans ~100× (Jetson AGX mode-0 vs
  TX2 mode-1); device work-modes are re-drawn every 20 rounds (paper).
* bandwidth: WiFi, fluctuating in [1, 30] Mb/s per round.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import rng as RNG

MODE_RESHUFFLE_PERIOD = 20      # rounds (paper §6.1)
BW_RANGE_BPS = (1e6, 30e6)      # 1–30 Mb/s
MU_RANGE_S = (0.002, 0.2)       # per-sample latency, 100× spread


@dataclasses.dataclass
class CapabilityModel:
    n_devices: int
    seed: int = 0

    def __post_init__(self):
        # own spawn kind: the root SeedSequence(seed) stream was shared with
        # the dataset generator and partitioner (all get the same cfg.seed),
        # so the hardware-tier uniforms correlated with the data draw
        rng = RNG.stream(self.seed, RNG.KIND_CAP_TIER)
        # persistent device tier (hardware class), log-uniform
        self._tier = np.exp(rng.uniform(np.log(MU_RANGE_S[0]),
                                        np.log(MU_RANGE_S[1]),
                                        self.n_devices))
        self._bw_tier = rng.uniform(0.3, 1.0, self.n_devices)

    def _stream(self, kind: int, step: int) -> np.random.Generator:
        """Per-(seed, kind, step) generator via the SeedSequence spawn tree.

        ``SeedSequence(seed, spawn_key=(kind, step))`` is the stateless
        spelling of ``SeedSequence(seed).spawn(...)[kind].spawn(...)[step]``:
        every (seed, kind, step) triple keys an independent stream, unlike
        the former arithmetic seeds, which collided both across seeds
        ((seed=0, t=7919) and (seed=1, t=0) drew identical bandwidth under
        ``seed*7919 + t``) and across the mode/bandwidth families (for
        seed=0 both reduced to plain ``epoch`` / ``t``). Kinds live in
        ``repro.core.rng`` (0 = epoch work-mode, 1 = round bandwidth).
        """
        return RNG.stream(self.seed, kind, step)

    def snapshot(self, t: int):
        """Per-round (mu [n] s/sample, bw_down [n] b/s, bw_up [n] b/s)."""
        epoch = t // MODE_RESHUFFLE_PERIOD
        rng = self._stream(RNG.KIND_CAP_EPOCH, epoch)
        mode = np.exp(rng.normal(0.0, 0.5, self.n_devices))   # work-mode factor
        mu = np.clip(self._tier * mode, *MU_RANGE_S)
        rng_r = self._stream(RNG.KIND_CAP_ROUND, t)
        lo, hi = BW_RANGE_BPS
        bw_d = np.clip(self._bw_tier * rng_r.uniform(lo, hi, self.n_devices),
                       lo, hi)
        bw_u = np.clip(self._bw_tier * rng_r.uniform(lo, hi, self.n_devices),
                       lo, hi)
        return mu, bw_d, bw_u
