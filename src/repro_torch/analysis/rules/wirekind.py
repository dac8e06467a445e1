"""REP009/REP010 — fault-engine modules draw ONLY from KIND_FAULTS (the
port's copy of ``repro.analysis.rules.wirekind``; the scopes match the
same module names in both packages).

The wire-boundary engine's resume guarantee (a mid-run checkpoint restore
replays the identical dropout/Byzantine/corruption schedule) holds because
every fault draw is a pure function of (seed, KIND_FAULTS, t, ...) — no
wall state, no shared generator, no other kind. A draw in fl/faults.py,
fl/wire.py or fl/robust.py that keys any OTHER kind would silently couple
the fault schedule to an unrelated consumer's stream (REP001's
aliasing bug, reborn at the wire boundary), and a draw with no kind at all
is REP001's root-stream bug. REP009 pins the discipline structurally:
inside the wire modules, every ``stream``/``sequence`` call must name
``KIND_FAULTS`` as its kind argument.

REP010 extends the same contract to ``fl/availability.py``: the diurnal
availability schedule must replay identically across a checkpoint restore
too (DESIGN.md §12), so its draws share the KIND_FAULTS kind — in the
disjoint ``STEP_AVAIL = 1 << 20`` step namespace — rather than minting a
new kind the resume machinery would not know to re-key.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.lint import Rule, terminal_name

_STREAM_FNS = {"stream", "sequence"}


class _KindFaultsRule(Rule):
    """Shared check: every stream()/sequence() call in scope must name
    KIND_FAULTS as its kind (positional arg 1 or ``kind=`` keyword)."""

    what = "wire/fault"

    def check(self, src):
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            if terminal_name(node.func) not in _STREAM_FNS:
                continue
            kind = node.args[1] if len(node.args) >= 2 else None
            for kw in node.keywords:
                if kw.arg == "kind":
                    kind = kw.value
            if kind is None:
                yield self.diag(
                    src, node,
                    f"RNG stream without a kind argument — {self.what} "
                    "draws must key (seed, KIND_FAULTS, ...)")
            elif terminal_name(kind) != "KIND_FAULTS":
                yield self.diag(
                    src, node,
                    f"{self.what} modules own exactly one RNG kind; key "
                    "this draw with KIND_FAULTS (repro_torch.core.rng), not "
                    f"{terminal_name(kind) or 'a computed kind'}")


class REP009(_KindFaultsRule):
    code = "REP009"
    summary = "wire/fault RNG draw not keyed by KIND_FAULTS"
    scope = ("fl/wire.py", "fl/faults.py", "fl/robust.py")
    what = "wire/fault"


class REP010(_KindFaultsRule):
    code = "REP010"
    summary = "availability-schedule RNG draw not keyed by KIND_FAULTS"
    scope = ("fl/availability.py",)
    what = "availability-schedule"
