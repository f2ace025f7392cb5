"""Drive all registered rules over the port's files and produce a report."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.base import Finding, Rule, all_rules, is_suppressed
from repro_torch.analysis.baseline import (BASELINE_NAME, load_baseline,
                                           split_by_baseline)
from repro_torch.analysis.model import RepoModel


@dataclasses.dataclass
class Report:
    findings: List[Finding]  # all unsuppressed findings
    new: List[Finding]  # not covered by the baseline
    accepted: List[Finding]  # covered by the baseline
    stale_baseline: List[str]  # baseline fingerprints with no match
    rules: List[str]

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale_baseline

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "rules": self.rules,
            "counts": {
                "total": len(self.findings),
                "new": len(self.new),
                "accepted": len(self.accepted),
                "stale_baseline": len(self.stale_baseline),
            },
            "new": [f.to_dict() for f in self.new],
            "accepted": [f.to_dict() for f in self.accepted],
            "stale_baseline": self.stale_baseline,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_text(self) -> str:
        out: List[str] = []
        for f in self.new:
            out.append(f.render())
        for f in self.accepted:
            out.append(f"{f.render()}  [baseline]")
        for fp in self.stale_baseline:
            out.append(f"{BASELINE_NAME}: stale entry {fp} (prune it)")
        status = "OK" if self.ok else "FAIL"
        out.append(
            f"{status}: {len(self.new)} new, {len(self.accepted)} baseline, "
            f"{len(self.stale_baseline)} stale baseline "
            f"({len(self.rules)} rules)"
        )
        return "\n".join(out)


def run_rules(
    model: RepoModel, rules: Optional[Sequence[Rule]] = None
) -> List[Finding]:
    """All findings from ``rules`` (default: every registered rule),
    with suppression comments applied."""
    rules = list(rules) if rules is not None else all_rules()
    findings: List[Finding] = []
    for rule in rules:
        for f in rule.check(model):
            mod = model.modules.get(f.path)
            if mod is not None and is_suppressed(f, mod.lines):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


def analyze(
    root,
    rules: Optional[Sequence[Rule]] = None,
    use_baseline: bool = True,
) -> Report:
    model = RepoModel.load(root)
    findings = run_rules(model, rules)
    baseline: Dict[str, str] = load_baseline(root) if use_baseline else {}
    new, accepted, stale = split_by_baseline(findings, baseline)
    rule_ids = [r.id for r in (rules if rules is not None else all_rules())]
    return Report(
        findings=findings,
        new=new,
        accepted=accepted,
        stale_baseline=stale,
        rules=rule_ids,
    )
