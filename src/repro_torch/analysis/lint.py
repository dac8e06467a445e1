"""AST lint engine of the port's invariant checker: rule framework, noqa
handling, file walking — the port of ``repro.analysis.lint``.

Rules are small classes over the stdlib ``ast`` module — no third-party
linter machinery, because every rule here is repo-specific (ruff owns the
generic layer; see pyproject.toml). A rule examines one parsed module and
returns diagnostics; the engine strips diagnostics suppressed by an inline

    # repro: noqa=REP001            (one code)
    # repro: noqa=REP001,REP006     (several)
    # repro: noqa                   (every REPxxx rule on that line)

comment on the *flagged line*. Suppressions are deliberate and should carry
a justification in a neighbouring comment (DESIGN.md §10). The syntax is
the reference's, so one comment satisfies both linters.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Optional, Sequence

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\s*=\s*([A-Z0-9,\s]+))?",
                      re.IGNORECASE)

# Directories (repo-relative) the REPxxx rules skip. The configs/ trees are
# data, not engine code: LLM arch descriptions resolved dynamically by
# ``configs.get`` — a static entry-point walk cannot see them, and none
# contain round-loop or RNG logic. ruff still lints them.
QUARANTINE = ("src/repro/configs/", "src/repro_torch/configs/")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class SourceFile:
    """One parsed module plus its per-line noqa suppressions."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.noqa: dict[int, Optional[set]] = {}
        for i, line in enumerate(text.splitlines(), start=1):
            m = _NOQA_RE.search(line)
            if not m:
                continue
            codes = m.group(1)
            self.noqa[i] = (None if codes is None else
                            {c.strip().upper() for c in codes.split(",")
                             if c.strip()})

    def suppressed(self, rule: str, line: int) -> bool:
        if line not in self.noqa:
            return False
        codes = self.noqa[line]
        return codes is None or rule in codes


class Rule:
    """Base class: subclasses set ``code``/``summary`` and implement
    ``check(src) -> Iterable[Diagnostic]`` (noqa filtering is the
    engine's job, not the rule's)."""

    code = "REP000"
    summary = ""
    # None = every file; otherwise substrings a path must contain
    scope: Optional[Sequence[str]] = None

    def applies(self, path: str) -> bool:
        if self.scope is None:
            return True
        norm = path.replace("\\", "/")
        return any(s in norm for s in self.scope)

    def check(self, src: SourceFile) -> Iterable[Diagnostic]:
        raise NotImplementedError

    def diag(self, src: SourceFile, node: ast.AST, message: str) -> Diagnostic:
        return Diagnostic(self.code, src.path, node.lineno, node.col_offset,
                          message)


# --- shared AST helpers -----------------------------------------------------

# module names whose calls are device ops: the reference's and PyTorch's
DEVICE_LIBS = ("jnp", "jax", "torch")


def attr_chain(node: ast.AST) -> str:
    """Dotted source-ish name for Name/Attribute chains ('' otherwise)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return attr_chain(call.func)


def terminal_name(node: ast.AST) -> str:
    """Last identifier of a Name/Attribute ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def own_nodes(stmt: ast.stmt):
    """A statement's own nodes: its header expressions and, for simple
    statements, the full expression tree — but NOT nested statements
    (compound bodies are visited as statements of their own)."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, ast.stmt):
                stack.append(child)


def functions(tree: ast.AST):
    """All (Async)FunctionDef nodes, nested included."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# --- engine -----------------------------------------------------------------

def iter_py_files(paths: Sequence[str], root: Optional[str] = None):
    """Yield (display_path, abs_path) for every .py under ``paths``."""
    for p in paths:
        base = Path(p)
        files = [base] if base.is_file() else sorted(base.rglob("*.py"))
        for f in files:
            disp = str(f)
            if root:
                try:
                    disp = str(f.relative_to(root))
                except ValueError:
                    pass
            if any(q in disp.replace("\\", "/") for q in QUARANTINE):
                continue
            yield disp, f


def lint_source(src: SourceFile, rules: Sequence[Rule]):
    """Returns (diagnostics, n_suppressed) for one file."""
    out, suppressed = [], 0
    for rule in rules:
        if not rule.applies(src.path):
            continue
        for d in rule.check(src):
            if src.suppressed(d.rule, d.line):
                suppressed += 1
            else:
                out.append(d)
    return out, suppressed


def run_lint(paths: Sequence[str], rules: Optional[Sequence[Rule]] = None,
             root: Optional[str] = None):
    """Lint every .py under ``paths``. Returns (diagnostics, n_suppressed)."""
    if rules is None:
        from repro_torch.analysis.rules import ALL_RULES
        rules = ALL_RULES
    diags, suppressed = [], 0
    for disp, f in iter_py_files(paths, root=root):
        src = SourceFile(disp, f.read_text())
        d, s = lint_source(src, rules)
        diags.extend(d)
        suppressed += s
    diags.sort(key=lambda d: (d.path, d.line, d.rule))
    return diags, suppressed
