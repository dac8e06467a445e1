"""The paper's headline comparison on one dataset through the PyTorch port:
the five Table-3 schemes, then the traffic and simulated time each needs to
reach the highest accuracy every scheme reaches (the twin of
examples/compare_schemes.py, with the same per-dataset τ, b_max and round
budgets; it runs the comparison loop itself).

  PYTHONPATH=src python examples/compare_schemes_torch.py               # card
  PYTHONPATH=src python examples/compare_schemes_torch.py --device cpu \\
      --dataset har
"""
import argparse
import time

from repro_torch.core.caesar import CaesarConfig
from repro_torch.fl.simulation import SimConfig, Simulator

SCHEMES = ("fedavg", "flexcom", "prowd", "pyramidfl", "caesar")
# the reference harness's budgets (benchmarks/common.py)
TAUS = {"har": 5, "cifar10": 10, "speech": 10, "oppo_ts": 10}
ROUNDS = {"har": 30, "cifar10": 30, "speech": 24, "oppo_ts": 24}
BMAX = {"har": 16, "cifar10": 32, "speech": 32, "oppo_ts": 32}
FAST = dict(n_clients=30, participation=0.2, data_scale=0.05, eval_every=2)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="har", choices=sorted(TAUS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per scheme (default: the dataset's budget)")
    args = ap.parse_args()
    ds = args.dataset
    hists = {}
    for scheme in SCHEMES:
        cfg = SimConfig(dataset=ds, scheme=scheme,
                        rounds=args.rounds or ROUNDS[ds],
                        caesar=CaesarConfig(tau=TAUS[ds], b_max=BMAX[ds]),
                        device=args.device, **FAST)
        t0 = time.perf_counter()
        hists[scheme] = Simulator(cfg).run(log=print)
        print(f"== {scheme}: {time.perf_counter() - t0:.1f} s wall")
    # Table-3 convention: the target is the highest accuracy ALL reach
    target = min(max(h.accuracy) for h in hists.values())
    base = hists["fedavg"].to_target(target)
    print(f"\ntarget acc = {target:.3f}")
    for scheme in SCHEMES:
        h = hists[scheme]
        hit = h.to_target(target)
        t, gb, rnd = hit if hit else (float("nan"),) * 3
        saving = (f" saving_vs_fedavg={1 - gb / base[1]:.1%}"
                  if hit and base and base[1] > 0 else "")
        print(f"{scheme:10s} traffic={gb:.3f}GB time={t:.0f}s round={rnd} "
              f"acc={h.accuracy[-1]:.3f}{saving}")


if __name__ == "__main__":
    main()
