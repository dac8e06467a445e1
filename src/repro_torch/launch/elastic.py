"""Elastic scaling / failure handling for cohort-mode Caesar (Track B) —
the port of ``repro.launch.elastic``.

Caesar's own staleness machinery (Eq. 3) is the failure-recovery story: a
cohort (pod) that drops out stops participating; its staleness grows, and
when it rejoins Eq. 3 assigns it a gentle download ratio. This module is
the state surgery for the two pod-level events, on the leading pod axis of
`repro_torch.fl.distributed.TrainState`'s per-pod buffers:

* `shrink_state`: pods are lost — drop their per-pod buffers (prev/EF) and
  keep training on the survivors;
* `grow_state`: pods join — new cohorts start from the current global
  params with zeroed EF (never-participated clients: their first download
  is full precision, Eq. 3 at δ = t).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.fl.distributed import TrainState, tree_leaves, tree_map


def _slice_pods(tree, keep: list[int]):
    return tree_map(lambda a: a[torch.as_tensor(keep, device=a.device)],
                    tree)


def shrink_state(state: TrainState, lost_pods: list[int]) -> TrainState:
    """Remove failed pods' cohort state. Survivors keep training."""
    if state.prev_params is None and state.ef is None:
        return state
    n = tree_leaves(state.prev_params if state.prev_params is not None
                    else state.ef)[0].shape[0]
    lost = set(lost_pods)
    keep = [i for i in range(n) if i not in lost]
    if not keep:
        raise ValueError("all pods lost")
    return dataclasses.replace(
        state,
        prev_params=(_slice_pods(state.prev_params, keep)
                     if state.prev_params is not None else None),
        ef=_slice_pods(state.ef, keep) if state.ef is not None else None)


def grow_state(state: TrainState, n_new: int) -> TrainState:
    """Add cohorts: fresh pods adopt the global params (never-participated
    semantics — first download is full precision under Eq. 3)."""
    def grow_prev(a, p):
        fresh = p[None].expand((n_new,) + tuple(p.shape)).to(a.dtype)
        return torch.cat([a, fresh], dim=0)

    def grow_ef(a):
        return torch.cat([a, torch.zeros((n_new,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=a.device)])

    return dataclasses.replace(
        state,
        prev_params=(tree_map(grow_prev, state.prev_params, state.params)
                     if state.prev_params is not None else None),
        ef=tree_map(grow_ef, state.ef) if state.ef is not None else None)
