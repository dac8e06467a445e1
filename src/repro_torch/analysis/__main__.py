"""``python -m repro_torch.analysis`` — run the port's invariant checker.

Layers (each skippable):

* ``lint``       AST rules REP001–REP010 over src/repro_torch and
                 examples/*_torch.py (or explicit paths)
* ``contracts``  runtime contracts on the real round engines and the
                 Track-B step
* ``ownership``  instrumented pipelined runs asserting thread ownership

The contracts and the audit run on the card unless ``--device cpu``; with
``cuda`` and no card the command raises before anything runs. On the CPU
the sync contract reports that it needs a card, which is neither a pass
nor a failure.

``--strict`` exits 1 on any diagnostic or failed contract (the CI gate);
without it the suite reports and exits 0.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis.lint import run_lint

DEFAULT_PATHS = ("src/repro_torch", "examples/*_torch.py")
LAYERS = ("lint", "contracts", "ownership")


def default_paths(root: pathlib.Path) -> list:
    out = []
    for p in DEFAULT_PATHS:
        out.extend(sorted(root.glob(p)) if "*" in p else
                   [root / p] if (root / p).exists() else [])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis + contract verification")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any finding (CI gate)")
    ap.add_argument("--skip", action="append", default=[], choices=LAYERS,
                    help="skip a layer (repeatable)")
    ap.add_argument("--no-track-b", action="store_true",
                    help="skip the Track B step inside contracts")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the contracts and the audit run")
    args = ap.parse_args(argv)

    if not {"contracts", "ownership"} <= set(args.skip):
        from repro_torch.fl.driver import resolve_device
        resolve_device(args.device)      # raises for cuda without a card

    root = pathlib.Path(__file__).resolve().parents[3]
    failed = False

    if "lint" not in args.skip:
        paths = ([pathlib.Path(p) for p in args.paths] if args.paths
                 else default_paths(root))
        diags, n_suppressed = run_lint(paths, root=root)
        for d in diags:
            print(d)
        print(f"[lint] {len(diags)} diagnostics, "
              f"{n_suppressed} suppressed", file=sys.stderr)
        failed |= bool(diags)

    if "contracts" not in args.skip:
        from repro_torch.analysis.contracts import run_contracts
        reports = run_contracts(track_b=not args.no_track_b,
                                device=args.device)
        for r in reports:
            print(r)
        failed |= any(r.failed for r in reports)

    if "ownership" not in args.skip:
        from repro_torch.analysis.ownership import run_ownership
        reports = run_ownership(device=args.device)
        for r in reports:
            print(r)
        failed |= any(r.failed for r in reports)

    if failed:
        print("[analysis] FINDINGS" + (" (strict: exit 1)" if args.strict
                                       else ""), file=sys.stderr)
        return 1 if args.strict else 0
    print("[analysis] clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
