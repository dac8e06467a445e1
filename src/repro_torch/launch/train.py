"""End-to-end Track-B training launcher (cohort-mode Caesar) — the port of
``repro.launch.train``: Caesar round scheduling, checkpoint/restart and
resume, on the card unless ``--device cpu`` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20 --batch 8 --seq 128 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --steps 5 \
      --error-feedback          # Qwen1.5-4B at full width on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
      --smoke --device cpu --steps 4   # any arch of repro_torch.configs

The step runs on a pod mesh (`launch.mesh.Mesh`): by default the (1, 1)
local mesh of one process, as the reference's ``main``; with
``--production-mesh`` the (16, 16) mesh over a torchrun world of 256
ranks (anything else raises); from Python, ``run(args, mesh=...)`` takes
any mesh over the current world, e.g. ``make_mesh((2, 2, 2), ("pod",
"data", "model"))`` in a world of 8. Every rank draws the same global
batch and the step takes its own rows; rank 0 logs, and saves the
gathered state, which every rank restores whole and then shards.

``--arch`` takes every arch id: the encoder trains on audio frames, the VLM
on image patches plus ``seq − n_patches`` text tokens (InternVL2's 256
patches need ``--seq`` above 256, e.g. 384, for any text to predict).

Batches come from ``RNG.stream(seed, KIND_DATASET)``, the reference's
token stream. On resume the stream is advanced past the steps already
taken, so a restarted run sees the batches the uninterrupted run saw (the
reference restarts the stream from its seed). Weights are random, drawn
from a ``torch.Generator`` seeded with ``--seed`` on the run's device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import rng as RNG
from repro_torch.core import staleness as ST
from repro_torch.fl import distributed as D
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M


def make_batch(rng: np.random.Generator, cfg, batch: int, seq: int,
               device) -> dict:
    """One batch drawn as the reference's: {"tokens", "labels"} [batch,
    seq] int32; for the audio frontend {"frames" [batch, seq, F] f32,
    "labels"} (labels drawn after the frames); for the vision frontend
    {"tokens", "labels"} [batch, seq − n_patches] and {"patches" [batch,
    n_patches, F]} f32. The tokens are drawn first in every case, so the
    stream advances the same way."""
    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.frontend == "audio":
        out = {"frames": rng.normal(size=(batch, seq, cfg.frontend_dim))
               .astype(np.float32),
               "labels": rng.integers(0, cfg.vocab, (batch, seq))
               .astype(np.int32)}
    elif cfg.frontend == "vision":
        st = seq - cfg.n_patches
        out = {"tokens": toks[:, :st],
               "patches": rng.normal(size=(batch, cfg.n_patches,
                                           cfg.frontend_dim))
               .astype(np.float32),
               "labels": toks[:, :st]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


def download_schedule(steps: int, theta_d_max: float) -> np.ndarray:
    """θ_d per step: Eq. 3 with δ = 1 for the single cohort that takes part
    every round (t ≥ 1), precomputed once as the reference does; step 0
    downloads at full precision."""
    sched = np.array([float(ST.download_ratio(
        torch.ones(1, dtype=torch.int32), max(t, 1), theta_d_max)[0])
        for t in range(max(steps, 1))], np.float32)
    sched[0] = 0.0
    return sched


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--theta-d-max", type=float, default=0.6)
    ap.add_argument("--theta-u", type=float, default=0.35)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) data x model mesh over a torchrun "
                    "world of 256 ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def run(args, log: Callable[[str], None] = print, cfg=None,
        mesh=None, on_step: Callable | None = None) -> dict:
    """Train ``args.steps`` steps (from the latest checkpoint, if any).
    ``cfg`` replaces the model config that ``--arch``/``--smoke`` name
    (a caller's cut of depth; ``--tau`` still applies); ``mesh`` replaces
    the local mesh (a smaller mesh than ``--production-mesh``);
    ``on_step(t, state, loss)`` runs on every rank after each step. Returns
    this rank's final state, the step function, the mesh, the per-step
    losses and host walls, and the step the run started from."""
    dev = M.resolve_device(args.device)
    if args.production_mesh:
        MESH.init_distributed(device=dev)
        mesh = MESH.make_production_mesh(device=dev)
    elif mesh is None:
        mesh = MESH.make_local_mesh(dev)
    M.check_mesh(mesh, dev)
    dev = mesh.device
    lead = mesh.rank == 0
    if cfg is None:
        cfg = configs.get(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, local_iters=args.tau)
    dcfg = D.DistConfig(theta_d=0.0, theta_u=args.theta_u, local_lr=args.lr,
                        use_error_feedback=args.error_feedback)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, dev)
    state = D.init_state(params, dcfg, mesh, cfg)
    del params
    step_fn = D.make_train_step(cfg, dcfg, mesh, device=dev)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.steps():
        # every rank restores the whole tree, then keeps its part
        got = mgr.restore_latest(D.gather_state(state, cfg, dcfg, mesh))
        if got:
            state, start = D.shard_state(got[0], cfg, dcfg, mesh), got[1]
            if lead:
                log(f"[train] resumed from checkpoint step {start}")

    def save(step: int) -> None:
        whole = D.gather_state(state, cfg, dcfg, mesh)
        if lead:
            mgr.save(whole, step)
        # no rank goes on (and may look for this checkpoint) before it
        # is written
        mesh.barrier()

    rng = RNG.stream(args.seed, RNG.KIND_DATASET)
    for _ in range(start):                   # the batches already taken
        make_batch(rng, cfg, args.batch, args.seq, "cpu")
    td_sched = download_schedule(args.steps, args.theta_d_max)
    losses, walls = [], []
    for t in range(start, args.steps):
        theta_d = float(td_sched[t])
        state = dataclasses.replace(state, theta_d=torch.full(
            (), theta_d, dtype=torch.float32, device=dev))
        batch = make_batch(rng, cfg, args.batch, args.seq, dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        # the per-step loss print is this launcher's logging cadence: the
        # read waits for the step
        loss = float(metrics["loss"])
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        if on_step is not None:
            on_step(t, state, loss)
        if lead:
            log(f"[train] step {t:4d} loss={loss:.4f} θ_d={theta_d:.3f} "
                f"θ_u={args.theta_u} ({walls[-1]:.2f}s)")
        if mgr and (t + 1) % args.ckpt_every == 0:
            save(t + 1)
            if lead:
                log(f"[train] checkpointed step {t + 1}")
    if mgr:
        save(args.steps)
    return {"state": state, "step_fn": step_fn, "cfg": cfg, "mesh": mesh,
            "losses": losses, "walls": walls, "start": start}


def main(argv=None):
    run(parser().parse_args(argv))
    print("[train] done")


if __name__ == "__main__":
    main()
