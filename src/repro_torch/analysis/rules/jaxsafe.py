"""REP004/REP005/REP007 — device-math hygiene (the port's copy of
``repro.analysis.rules.jaxsafe``). The codes and what they match are the
reference's; what each guards in eager PyTorch:

* REP004 — a buffer passed at a donated position is dead after the call.
  In the reference XLA may alias its memory into the outputs. The port
  has no donation: its steps write the pool in place (``index_copy_``) or
  return fresh tensors. The same discipline still guards it — a buffer a
  step updates in place must not be read afterwards as if it held the old
  values, and a caller that keeps using the argument instead of the
  returned tensor reads the pre-step value. The rule knows the donating
  callees and their positions (``_DONATING``, the reference's names; the
  port's ``_finalize`` keeps position 0) and flags any use of a donated
  argument after the call unless the same statement rebinds it.
* REP005 — numpy float arrays created without an explicit dtype are f64;
  ``torch.from_numpy`` of one makes an f64 tensor, which promotes every op
  it meets to f64 on the card (the reference downcast it at the jit
  boundary). Device-adjacent code must spell dtypes: the reference's
  device-math modules and the port's ``core/``, ``kernels/`` and
  ``fl/executor``.
* REP007 — wall-clock reads (``time.*``, ``datetime.*``) in jitted code are
  baked in as constants at trace time. The port traces nothing (no
  ``jit``; eager PyTorch reads the clock on every call), so in the port
  the rule guards only a function handed to a ``jit`` — it keeps the
  reference's matching and adds no torch tracer to it.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import (Rule, attr_chain, functions,
                                       own_nodes, terminal_name)

# callee attr -> donated positional indices (the reference's jax.jit
# donate_argnums)
_DONATING = {
    "_round_step": (0, 1, 2),   # fl/executor.py (global_f, pool, ef)
    "_tier_chunk": (0, 1, 2),   # fl/executor.py (buf, ef, up_sum)
    "_finalize": (0,),          # fl/executor.py (global_f)
    "_scatter": (0,),           # fl/state.py (pool rows)
}


def _expr_key(node: ast.AST) -> str:
    """Stable text key for Name/self.X/X.Y argument expressions."""
    return attr_chain(node)


def _assigned_keys(stmt: ast.stmt) -> set:
    """Keys rebound by this statement (tuple targets flattened)."""
    out = set()
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    while targets:
        t = targets.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            targets.extend(t.elts)
        else:
            k = _expr_key(t)
            if k:
                out.add(k)
    return out


class REP004(Rule):
    code = "REP004"
    summary = "use of a donated buffer after the donating jit call"

    def check(self, src):
        for fn in functions(src.tree):
            # linearize the function's statements in source order
            stmts = sorted(
                (n for n in ast.walk(fn) if isinstance(n, ast.stmt)
                 and n is not fn),
                key=lambda n: (n.lineno, n.col_offset))
            donated: dict[str, int] = {}        # key -> donation line
            for stmt in stmts:
                rebound = _assigned_keys(stmt)
                # uses in this statement (before rebinds take effect,
                # except self-rebinding donating calls handled below)
                for node in own_nodes(stmt):
                    if isinstance(node, (ast.Name, ast.Attribute)) and \
                            isinstance(getattr(node, "ctx", None), ast.Load):
                        k = _expr_key(node)
                        if k in donated and k not in rebound and \
                                node.lineno > donated[k]:
                            yield self.diag(
                                src, node,
                                f"'{k}' was donated at line "
                                f"{donated[k]} — its buffer may be "
                                "aliased into the outputs; rebind or "
                                "re-fetch it")
                            donated.pop(k, None)
                for k in rebound:
                    donated.pop(k, None)
                for node in own_nodes(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    positions = _DONATING.get(terminal_name(node.func))
                    if positions is None:
                        continue
                    for i in positions:
                        if i < len(node.args):
                            k = _expr_key(node.args[i])
                            if k and k not in rebound:
                                donated[k] = node.lineno


_NP_FLOAT_CTORS = {"array", "asarray", "full", "zeros", "ones", "empty",
                   "arange", "linspace"}


def _has_dtype(call: ast.Call) -> bool:
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    # positional dtype: np.asarray(x, np.float32) / np.full(n, v, np.f32)
    for arg in call.args[1:]:
        name = terminal_name(arg)
        if name and ("float" in name or "int" in name or "bool" in name
                     or name == "dtype"):
            return True
    return False


def _mentions_float_literal(call: ast.Call) -> bool:
    for arg in call.args:
        for node in ast.walk(arg):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             float):
                return True
    return False


class REP005(Rule):
    code = "REP005"
    summary = "implicit f64 promotion touching device buffers"
    # device-math modules only: host accounting (driver) legitimately
    # computes in f64. The reference's, and the port's modules whose numpy
    # arrays become tensors through torch.from_numpy
    scope = ("repro/core/", "repro/kernels/", "repro/fl/executor",
             "repro/fl/distributed", "repro/fl/state", "repro/models/",
             "repro_torch/core/", "repro_torch/kernels/",
             "repro_torch/fl/executor")

    def check(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = terminal_name(node.func)
            if tail in ("float64", "double"):
                yield self.diag(
                    src, node,
                    "explicit f64 in a device-math module: it flips the "
                    "ops it meets to f64 (the reference's jit downcast it "
                    "with x64 off)")
                continue
            parts = attr_chain(node.func).split(".")
            if len(parts) == 2 and parts[0] in ("np", "numpy") and \
                    parts[1] in _NP_FLOAT_CTORS and \
                    not _has_dtype(node) and _mentions_float_literal(node):
                yield self.diag(
                    src, node,
                    f"np.{parts[1]} with float data and no dtype creates "
                    "an f64 host array (torch.from_numpy keeps f64); "
                    "spell the dtype")


_TIME_CALLS = {"time", "perf_counter", "monotonic", "process_time", "now",
               "utcnow", "today"}


def _jitted_functions(tree):
    """Defs that are jitted: decorated with jit/partial(jax.jit,...) or
    passed to a jax.jit(...)/jit(...) call in this module — plus their
    nested defs (traced as part of the closure)."""
    idx = {fn.name: fn for fn in functions(tree)}
    jitted = []

    def is_jit_expr(node):
        if terminal_name(node) == "jit":
            return True
        if isinstance(node, ast.Call):
            return any(is_jit_expr(a) for a in
                       list(node.args) + [kw.value for kw in node.keywords]
                       ) or is_jit_expr(node.func)
        return False

    for fn in functions(tree):
        if any(is_jit_expr(d) for d in fn.decorator_list):
            jitted.append(fn)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                terminal_name(node.func) == "jit" and node.args:
            name = terminal_name(node.args[0])
            if name in idx:
                jitted.append(idx[name])
    # nested defs trace with their parent
    out = []
    seen = set()
    for fn in jitted:
        for sub in [fn, *functions(fn)]:
            if id(sub) not in seen:
                seen.add(id(sub))
                out.append(sub)
    return out


class REP007(Rule):
    code = "REP007"
    summary = "wall-clock value traced into jitted code"

    def check(self, src):
        for fn in _jitted_functions(src.tree):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                parts = attr_chain(node.func).split(".")
                if len(parts) >= 2 and parts[0] in ("time", "datetime") \
                        and parts[-1] in _TIME_CALLS:
                    yield self.diag(
                        src, node,
                        f"{'.'.join(parts)} inside jitted "
                        f"'{fn.name}' is baked in at trace time — the "
                        "compiled step replays its first timestamp "
                        "forever")
