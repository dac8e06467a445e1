"""End-to-end Track-B driver on PyTorch: cohort-mode Caesar training of a
reduced qwen1.5-4b (≈67M parameters, f32) with checkpoint/restart — the
port of ``examples/train_lm_cohort.py``, on the card unless ``--device
cpu`` is given.

  PYTHONPATH=src python examples/train_lm_cohort_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_lm_cohort_torch.py --device cpu \
      --steps 30 --batch 2 --seq 64

The token stream is the reference example's learnable one (periodic
patterns plus noise from ``RNG.stream(0, KIND_DATASET)``). A restart
advances the stream past the steps already taken, so the resumed run sees
the batches the uninterrupted run saw. Checkpoints go to ``--ckpt``
(default ``build/caesar_lm_ckpt`` in the checkout).

Every other arch and family (MoE, MLA, Mamba2, the Zamba2 hybrid, the
HuBERT encoder on audio frames, InternVL2 on image patches) trains through
the same step with the Track-B launcher: ``python -m repro_torch.launch.train
--arch <id> [--smoke --device cpu]``.
"""
import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import rng as RNG
from repro_torch.fl import distributed as D
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]


def config():
    """≈67M params: 8 layers, d=512, vocab 32768 (qwen family, shrunk)."""
    return dataclasses.replace(
        configs.get("qwen1.5-4b"), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, d_head=64, d_ff=2048, vocab=32768, dtype="float32",
        remat=False, local_iters=1, name="qwen-115m")


DIST = D.DistConfig(theta_d=0.3, theta_u=0.35, local_lr=3e-3,
                    use_error_feedback=True)


def batch_at(rng: np.random.Generator, t: int, batch: int, seq: int,
             vocab: int, device) -> dict:
    """Step t's batch: periodic token patterns + noise (draws from ``rng``,
    so batches must be taken in step order)."""
    base = (np.arange(seq)[None] * (1 + t % 7)) % 1024
    toks = (base + rng.integers(0, 4, (batch, seq))) % vocab
    toks = torch.from_numpy(toks.astype(np.int32)).to(device)
    return {"tokens": toks, "labels": toks}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "caesar_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = M.resolve_device(args.device)
    cfg = config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    n_params = sum(x.numel() for x in D.tree_leaves(params))
    print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params")
    state = D.init_state(params, DIST)
    step_fn = D.make_train_step(cfg, DIST, device=dev)
    mgr = CheckpointManager(args.ckpt, keep=2)
    start = 0
    got = mgr.restore_latest(state)
    if got:
        state, start = got
        print(f"resumed at step {start}")
    rng = RNG.stream(0, RNG.KIND_DATASET)
    for t in range(start):                   # the batches already taken
        batch_at(rng, t, args.batch, args.seq, cfg.vocab, "cpu")
    t0 = time.time()
    for t in range(start, args.steps):
        state, m = step_fn(state, batch_at(rng, t, args.batch, args.seq,
                                           cfg.vocab, dev))
        if t % 20 == 0 or t == args.steps - 1:
            # logging boundary, every 20 steps: the read waits for the step
            loss = float(m["loss"])  # repro: noqa=REP006
            print(f"step {t:4d} loss={loss:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if (t + 1) % 100 == 0:
            mgr.save(state, t + 1)
    mgr.save(state, args.steps)
    print("done")


if __name__ == "__main__":
    main()
