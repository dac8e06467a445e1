"""REP003/REP008 — what the prefetch worker thread may touch (the port's
copy of ``repro.analysis.rules.threads``).

The pipelined driver's worker prefetches round t+1 while the device steps
round t. Two disciplines keep that race-free (fl/driver.py module
docstring, DESIGN.md §10):

* REP003 — no device-library ops in the worker's (same-module) call graph:
  ``jnp``/``jax`` as in the reference, and ``torch``. Worker-side device
  work contends with the in-flight step for the host cores that enqueue
  it and erases the pipeline win; worse, a device call from the worker
  can interleave with the step's in-place pool writes. The ONE sanctioned
  exception — ragged-mode caesar planning, which runs torch on the CPU —
  lives behind a cross-module call (``self.planner.plan``), which this
  same-module rule deliberately does not descend into: the planner owns
  that contract.
* REP008 — no ClientStateStore mutation (``prepare``/``adopt``/slot-map
  writes) off the main thread: the round step writes the pool in place
  (the reference donates it through the jitted step), so a worker-side
  prepare would grow or scatter a buffer the in-flight step still uses.

Both rules build the worker call graph statically: entry points are
functions submitted to an executor (``pool.submit(fn, ...)``) plus any
function named in ``WORKER_ENTRY_NAMES``; edges follow same-module
``name(...)`` and ``self.method(...)`` calls.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import DEVICE_LIBS, Rule, attr_chain, functions

WORKER_ENTRY_NAMES = {"_prefetch_pkg", "_prefetch_round"}

_STORE_MUTATORS = {"prepare", "adopt", "_activate", "_grow", "_evict",
                   "_restore", "load_state_dict"}
_SLOT_MAPS = {"slot_of", "client_of", "last_used", "evicted_tier", "pool",
              "ef_pool", "centroids"}


def _function_index(tree):
    """name -> [FunctionDef] for every def in the module (nested incl.)."""
    idx: dict[str, list] = {}
    for fn in functions(tree):
        idx.setdefault(fn.name, []).append(fn)
    return idx


def _called_names(fn):
    """Names of same-module callables invoked from ``fn``'s body:
    bare ``name(...)`` and ``self.method(...)`` calls."""
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            out.add(f.id)
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self":
            out.add(f.attr)
    return out


def worker_reachable(tree):
    """FunctionDef nodes reachable from the module's worker entry points."""
    idx = _function_index(tree)
    entries = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "submit" and node.args:
            target = node.args[0]
            name = (target.id if isinstance(target, ast.Name) else
                    target.attr if isinstance(target, ast.Attribute) else
                    None)
            if name:
                entries.add(name)
    entries |= (WORKER_ENTRY_NAMES & idx.keys())

    seen: list = []
    seen_names = set()
    frontier = [n for n in entries if n in idx]
    while frontier:
        name = frontier.pop()
        if name in seen_names:
            continue
        seen_names.add(name)
        for fn in idx[name]:
            seen.append(fn)
            frontier.extend(c for c in _called_names(fn)
                            if c in idx and c not in seen_names)
    return seen


class REP003(Rule):
    code = "REP003"
    summary = "jnp/jax/torch device op reachable from the prefetch worker"

    def check(self, src):
        for fn in worker_reachable(src.tree):
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and node.id in DEVICE_LIBS:
                    yield self.diag(
                        src, node,
                        f"'{node.id}' used in '{fn.name}', which the "
                        "prefetch worker reaches — device ops off the "
                        "main thread contend with the in-flight step "
                        "(keep the producer pure numpy)")


class REP008(Rule):
    code = "REP008"
    summary = "ClientStateStore mutated off the main thread"

    def check(self, src):
        for fn in worker_reachable(src.tree):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _STORE_MUTATORS and \
                        "store" in attr_chain(node.func.value).lower():
                    yield self.diag(
                        src, node,
                        f"store.{node.func.attr}() in worker-reachable "
                        f"'{fn.name}' — the in-flight step writes the "
                        "pool; store calls belong on the main thread "
                        "(prepare → step)")
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for tgt in targets:
                        if isinstance(tgt, ast.Attribute) and \
                                tgt.attr in _SLOT_MAPS and \
                                "store" in attr_chain(tgt.value).lower():
                            yield self.diag(
                                src, tgt,
                                f"write to store.{tgt.attr} in worker-"
                                f"reachable '{fn.name}' — slot maps are "
                                "main-thread state")
