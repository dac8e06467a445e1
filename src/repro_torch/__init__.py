"""PyTorch + CUDA port of the Caesar reproduction (``repro``), for NVIDIA
Hopper (H100, ``sm_90a``).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``data/``, ``kernels/``, ``models/``, ``optim/``, ``fl/``) and
names, imports ``torch`` and numpy only, and never imports ``jax`` or
``repro``. The Pallas kernels on the Track-A round's path are hand-written
CUDA kernels here (``kernels/csrc/``), each with a plain PyTorch twin.

Entry point: ``repro_torch.fl.simulation.Simulator(SimConfig(...))``, which
runs on the card by default (``device="cuda"``) and raises when there is
none.
"""
