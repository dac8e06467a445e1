"""REP006 — no device syncs inside the round hot loop (the port's copy of
``repro.analysis.rules.hotloop``, reading PyTorch's names beside jax's).

``float()``, ``.item()`` and ``np.asarray()`` on a device array BLOCK until
the device finishes; so do ``.tolist()``, ``.cpu()`` and ``.numpy()`` on a
CUDA tensor. Inside the per-round loop that serializes host and device and
erases the pipeline overlap (keeping the loop async bought ~4–7× in the
reference). The rule runs a small intra-function taint pass:

* sources — values returned by known device-stepping callees
  (``_TAINT_SOURCES``: executor steps, device helpers, any ``jnp.``/
  ``jax.``/``torch.`` call);
* propagation — through assignments (tuple unpacking included);
* sinks — ``float(x)`` / ``int(x)`` / ``np.asarray(x)`` / ``np.array(x)``
  / ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()`` over a
  tainted expression **inside a for/while loop**. A sink also *untaints*
  its result: the documented once-per-round accounting sync (driver.run)
  reads everything afterwards from host arrays, which is exactly the
  pattern to keep.

Deliberate syncs (the accounting point, eval boundaries, legacy-parity
benchmarks) carry ``# repro: noqa=REP006`` with a justification.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import (DEVICE_LIBS, Rule, attr_chain,
                                       functions, own_nodes, terminal_name)

# attribute names whose call results live on device
_TAINT_SOURCES = {"step", "step_ragged", "step_ragged_deferred",
                  "_round_step", "_tier_chunk", "_tier_chunk_defer",
                  "_finalize", "_hist", "_eval", "lr_at", "_gather",
                  "_to_f32", "_round_vmapped", "apply_fn"}
_SINK_FUNCS = {"float", "int"}
_NP_SINKS = {"asarray", "array"}
# tensor methods that copy to the host: .item() as in the reference, and
# PyTorch's readbacks
_METHOD_SINKS = {"item", "tolist", "cpu", "numpy"}


def _is_source_call(node: ast.Call) -> bool:
    parts = attr_chain(node.func).split(".")
    if parts and parts[0] in DEVICE_LIBS:
        return True
    return terminal_name(node.func) in _TAINT_SOURCES


def _sink_kind(node: ast.Call) -> str:
    """'' if not a sink; else a short label for the diagnostic."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in _SINK_FUNCS and node.args:
        return f.id + "()"
    parts = attr_chain(f).split(".")
    if len(parts) == 2 and parts[0] in ("np", "numpy") and \
            parts[1] in _NP_SINKS and node.args:
        return "np." + parts[1]
    if isinstance(f, ast.Attribute) and f.attr in _METHOD_SINKS:
        return f".{f.attr}()"
    return ""


class _Taint:
    """Forward taint over one function body, statement order."""

    def __init__(self):
        self.tainted: set[str] = set()

    def expr_tainted(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                if _sink_kind(sub):
                    # a sync produces a host value; don't let the walk
                    # see through it (its own argument is judged where
                    # the sink itself is visited)
                    return False
                if _is_source_call(sub):
                    return True
            if isinstance(sub, (ast.Name, ast.Attribute)):
                k = attr_chain(sub)
                if k and k in self.tainted:
                    return True
        return False

    def assign(self, stmt: ast.stmt):
        if isinstance(stmt, ast.Assign):
            value_tainted = self.expr_tainted(stmt.value)
            targets = list(stmt.targets)
            while targets:
                t = targets.pop()
                if isinstance(t, (ast.Tuple, ast.List)):
                    targets.extend(t.elts)
                    continue
                k = attr_chain(t)
                if not k:
                    continue
                if value_tainted:
                    self.tainted.add(k)
                else:
                    self.tainted.discard(k)


class REP006(Rule):
    code = "REP006"
    summary = "blocking device sync inside the round hot loop"

    def check(self, src):
        for fn in functions(src.tree):
            taint = _Taint()
            stmts = sorted(
                (n for n in ast.walk(fn)
                 if isinstance(n, ast.stmt) and n is not fn),
                key=lambda n: (n.lineno, n.col_offset))
            # loop line spans: (start, end) of every for/while body
            loops = [(n.lineno, max(getattr(n, "end_lineno", n.lineno),
                                    n.lineno))
                     for n in ast.walk(fn)
                     if isinstance(n, (ast.For, ast.While))]

            def in_loop(line):
                return any(a < line <= b for a, b in loops)

            for stmt in stmts:
                for node in own_nodes(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    kind = _sink_kind(node)
                    if not kind or not in_loop(node.lineno):
                        continue
                    probe = (node.args[0] if node.args else
                             node.func.value
                             if isinstance(node.func, ast.Attribute)
                             else None)
                    if probe is not None and taint.expr_tainted(probe):
                        yield self.diag(
                            src, node,
                            f"{kind} on a device value inside the round "
                            "loop blocks on the step — keep the loop "
                            "async (or suppress at the documented sync "
                            "point)")
                taint.assign(stmt)
