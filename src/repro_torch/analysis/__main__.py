"""CLI: ``python -m repro_torch.analysis lint`` over ``src/repro_torch``.

Exit status 0 when clean, 1 when any finding is reported, 2 for usage
errors.  ``--no-dynamic`` skips the rules that import the live code (twin
parity, scenario pickling) for pure-AST runs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.lint import default_src_root, format_report, run_lint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = parser.add_subparsers(dest="command", required=True)
    lint = sub.add_parser("lint", help="run the repo-specific AST lint")
    lint.add_argument(
        "--src", type=Path, default=None,
        help="package root to lint (default: the repro_torch package)",
    )
    lint.add_argument(
        "--no-dynamic", action="store_true",
        help="skip rules that import the live code (twin parity, pickling)",
    )
    args = parser.parse_args(argv)
    root = args.src if args.src is not None else default_src_root()
    findings = run_lint(root, dynamic=not args.no_dynamic)
    n_files = len(list(Path(root).rglob("*.py")))
    print(format_report(findings, n_files))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
