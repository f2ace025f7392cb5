"""CLI for the port's static-analysis pass: ``python -m repro_torch.analysis``."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.base import all_rules, get_rule
from repro_torch.analysis.baseline import (BASELINE_NAME, load_baseline,
                                           save_baseline)
from repro_torch.analysis.runner import analyze


def find_root(start: Path) -> Path:
    """Walk up from ``start`` to the directory holding ``src/repro_torch``."""
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return cur


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the PyTorch/CUDA port (trace-purity, "
        "rng-salt, kernel-twin, checkpoint-ladder, eager-validation, "
        "test hygiene, telemetry host sync).",
    )
    ap.add_argument("--root", default=None, help="repo root (default: auto)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--output", default=None, help="also write report here")
    ap.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help=f"ignore {BASELINE_NAME} (report every finding as new)",
    )
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help=f"rewrite {BASELINE_NAME} from current findings; existing "
        "justifications are kept, new entries get a TODO",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="list rule ids and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}: {rule.description}")
        return 0

    root = Path(args.root) if args.root else find_root(Path.cwd())
    rules = None
    if args.rules:
        rules = [get_rule(r.strip()) for r in args.rules.split(",")]

    report = analyze(root, rules=rules, use_baseline=not args.no_baseline)

    if args.update_baseline:
        old = load_baseline(root)
        path = save_baseline(root, report.findings, justifications=old)
        print(f"wrote {path} ({len(report.findings)} findings)")
        return 0

    text = report.to_json() if args.format == "json" else report.to_text()
    print(text)
    if args.output:
        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report.to_dict(), indent=2) + "\n")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
