"""Quickstart (PyTorch port): train the HAR CNN with Caesar's low-deviation
compression (Track A) on a CUDA card, through repro_torch, against
uncompressed FedAvg.

Runs the faithful multi-client FL simulator on a synthetic HAR-shaped task
and prints the traffic/accuracy trajectory of each scheme, as
examples/quickstart.py does with the JAX package.

  PYTHONPATH=src python examples/quickstart_torch.py            # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Sharded (one rank per shard of the client-state pool, DESIGN.md §7), under
torchrun; n_clients must divide over the ranks. Four gloo ranks on the CPU,
and four ranks sharing one card (NCCL refuses two ranks on one card, so
gloo there too):

  PYTHONPATH=src torchrun --nproc-per-node 4 examples/quickstart_torch.py \\
      --sharded --clients 40 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 examples/quickstart_torch.py \\
      --sharded --clients 40 --backend gloo
"""
import argparse

from repro_torch.core.caesar import CaesarConfig
from repro_torch.fl.simulation import SimConfig, Simulator
from repro_torch.launch import mesh as MESH


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--sharded", action="store_true",
                    help="one rank per shard (run under torchrun)")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend with --sharded "
                         "(default: nccl for --device cuda, gloo for cpu)")
    args = ap.parse_args()
    rank = 0
    if args.sharded:
        MESH.init_distributed(backend=args.backend, device=args.device)
        rank = MESH.make_data_group(args.device).rank
    say = print if rank == 0 else (lambda s: None)
    for scheme in ("caesar", "fedavg"):
        cfg = SimConfig(dataset="har", scheme=scheme, rounds=args.rounds,
                        n_clients=args.clients, participation=0.2,
                        data_scale=0.2, eval_every=5,
                        caesar=CaesarConfig(tau=5, b_max=16),
                        device=args.device, sharded=args.sharded,
                        multi_host=args.sharded)
        sim = Simulator(cfg)
        hist = sim.run(log=say)
        s = hist.summary()
        say(f"== {scheme} ({args.device}, {sim.n_dev} shard(s)): "
            f"acc={s['final_acc']:.3f} "
            f"traffic={s['total_traffic_gb']:.3f}GB "
            f"sim_time={s['total_time_s']:.0f}s\n")


if __name__ == "__main__":
    main()
