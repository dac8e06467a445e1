"""Quickstart (PyTorch port): train the HAR CNN with Caesar's low-deviation
compression (Track A) on a CUDA card, through repro_torch, against
uncompressed FedAvg.

Runs the faithful multi-client FL simulator on a synthetic HAR-shaped task
and prints the traffic/accuracy trajectory of each scheme, as
examples/quickstart.py does with the JAX package.

  PYTHONPATH=src python examples/quickstart_torch.py            # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core.caesar import CaesarConfig
from repro_torch.fl.simulation import SimConfig, Simulator


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    for scheme in ("caesar", "fedavg"):
        cfg = SimConfig(dataset="har", scheme=scheme, rounds=args.rounds,
                        n_clients=30, participation=0.2, data_scale=0.2,
                        eval_every=5, caesar=CaesarConfig(tau=5, b_max=16),
                        device=args.device)
        hist = Simulator(cfg).run(log=print)
        s = hist.summary()
        print(f"== {scheme} ({args.device}): acc={s['final_acc']:.3f} "
              f"traffic={s['total_traffic_gb']:.3f}GB "
              f"sim_time={s['total_time_s']:.0f}s\n")


if __name__ == "__main__":
    main()
