"""REP001/REP002 — host RNG must go through named SeedSequence streams
(the port's copy of ``repro.analysis.rules.rng``; the rules read the same
names in both packages).

The repo's determinism story (pipelined ≡ sync, replayable trajectories)
hangs on ``repro_torch.core.rng``: every draw keyed by (seed, kind, *steps).
Two historical failure modes are outlawed here:

* REP001 — *root-stream sharing*: ``default_rng(seed)`` /
  ``SeedSequence(seed)`` without a spawn_key collapse every caller handed
  the same config seed onto ONE stream (the dataset generator,
  partitioner and capability tier draw once consumed identical uniforms),
  and legacy ``np.random.*`` / stdlib ``random.*`` singletons are shared
  mutable state a worker thread can read out of lockstep.
* REP002 — *arithmetic seed derivation*: ``seed*CONST + t`` collides
  across (seed, t) pairs — a bug CapabilityModel once had.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import (Rule, attr_chain, call_name,
                                       functions, terminal_name)

# legacy numpy singleton API (module-level shared state)
_NP_SINGLETON = {"seed", "rand", "randn", "randint", "random", "choice",
                 "shuffle", "permutation", "uniform", "normal", "integers",
                 "random_sample", "standard_normal"}
# stdlib random module functions
_STDLIB_RANDOM = {"seed", "random", "randint", "uniform", "choice",
                  "choices", "shuffle", "sample", "randrange", "gauss",
                  "getrandbits", "betavariate", "expovariate"}
# calls that consume a seed; their args are REP002's scan surface
_SEED_CONSUMERS = {"default_rng", "SeedSequence", "RandomState", "PRNGKey",
                   "stream", "sequence"}


def _seedish(node: ast.AST) -> bool:
    name = terminal_name(node)
    return bool(name) and "seed" in name.lower()


def _is_seed_sequence_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and terminal_name(node.func) == "SeedSequence")


def _has_spawn_key(call: ast.Call) -> bool:
    return any(kw.arg == "spawn_key" for kw in call.keywords)


class REP001(Rule):
    code = "REP001"
    summary = ("host RNG outside named SeedSequence streams "
               "(use repro_torch.core.rng)")

    def check(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = call_name(node)
            parts = chain.split(".")
            tail = parts[-1]

            # np.random.seed / np.random.shuffle / ... (module singleton)
            if len(parts) >= 2 and parts[-2] == "random" and \
                    parts[0] in ("np", "numpy") and tail in _NP_SINGLETON:
                yield self.diag(src, node,
                                f"legacy numpy singleton np.random.{tail}; "
                                "draw from a repro_torch.core.rng stream")
                continue
            # stdlib random.* call
            if len(parts) == 2 and parts[0] == "random" and \
                    tail in _STDLIB_RANDOM:
                yield self.diag(src, node,
                                f"stdlib random.{tail} shares module state; "
                                "draw from a repro_torch.core.rng stream")
                continue
            if tail == "RandomState":
                yield self.diag(src, node,
                                "np.random.RandomState is the legacy "
                                "singleton API; use repro_torch.core.rng")
                continue
            if tail == "SeedSequence" and node.args and \
                    not _has_spawn_key(node):
                yield self.diag(src, node,
                                "root SeedSequence(seed) stream is shared "
                                "by every consumer of this seed; key it "
                                "with a repro_torch.core.rng kind")
                continue
            if tail != "default_rng":
                continue
            # default_rng(...) — decide whether the argument keys a stream
            if not node.args and not node.keywords:
                yield self.diag(src, node,
                                "default_rng() draws OS entropy — "
                                "non-reproducible; use repro_torch.core.rng")
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield self.diag(src, node,
                                "default_rng(<literal>) is a raw root "
                                "stream; use repro_torch.core.rng.stream")
            elif _seedish(arg):
                yield self.diag(src, node,
                                f"default_rng({attr_chain(arg) or 'seed'}) "
                                "aliases every other consumer of this "
                                "seed's root stream; use repro_torch.core.rng")
            elif _is_seed_sequence_call(arg) and not _has_spawn_key(arg):
                yield self.diag(src, node,
                                "default_rng(SeedSequence(...)) without a "
                                "spawn_key is still the root stream; key "
                                "it with a repro_torch.core.rng kind")
            # anything else (an existing Generator/SeedSequence object,
            # a spawn-keyed SeedSequence call) is a legitimate passthrough


def _binop_with_seed(node: ast.AST) -> bool:
    """A BinOp whose subtree mentions a seed-named identifier."""
    if not isinstance(node, ast.BinOp):
        return False
    return any(_seedish(n) for n in ast.walk(node))


def _walk_scope(scope):
    """Walk a scope's nodes without descending into nested functions
    (each def gets its own REP002 pass via ``functions``)."""
    stack = list(scope.body) if hasattr(scope, "body") else []
    while stack:
        node = stack.pop(0)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class REP002(Rule):
    code = "REP002"
    summary = "arithmetic seed derivation (seed*CONST+t collides)"

    def check(self, src):
        for fn in [src.tree, *functions(src.tree)]:
            # one-level local tracking: name = <seed arithmetic>
            derived: set[str] = set()
            for node in _walk_scope(fn):
                if isinstance(node, ast.Assign) and \
                        _binop_with_seed(node.value):
                    derived.update(t.id for t in node.targets
                                   if isinstance(t, ast.Name))
                if not isinstance(node, ast.Call):
                    continue
                if terminal_name(node.func) not in _SEED_CONSUMERS:
                    continue
                for arg in list(node.args) + \
                        [kw.value for kw in node.keywords]:
                    derived_name = (isinstance(arg, ast.Name)
                                    and arg.id in derived)
                    inline = any(_binop_with_seed(s) for s in ast.walk(arg))
                    if derived_name or inline:
                        yield self.diag(
                            src, node,
                            "arithmetic seed derivation collides across "
                            "(seed, step) pairs; use a spawn-key stream "
                            "(repro_torch.core.rng)")
                        break
