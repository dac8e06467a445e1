"""The port's invariant checker — the counterpart of ``repro.analysis``.

Three layers, one CLI (``python -m repro_torch.analysis``):

* ``lint``      — AST rules REP001–REP010 (the reference's codes, reading
                  PyTorch's names beside jax's) over the port's source;
* ``contracts`` — runtime assertions over the *real* round steps of a tiny
                  simulator and a Track-B step (no f64, pools written in
                  place, tier shapes on the lattice, no stray host sync);
* ``ownership`` — an instrumented pipelined run asserting the documented
                  thread-ownership handoffs (state store on main, ragged
                  planning on the worker).

Nothing here imports ``jax`` or the reference package.
"""
from repro_torch.analysis.lint import Diagnostic, run_lint  # noqa: F401
