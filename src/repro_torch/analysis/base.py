"""Core types for the port's static-analysis pass.

The analyzer is deliberately stdlib-only (``ast`` + ``json``): it must run
where torch is not installed, and it must never import the code it
inspects.  Rules receive a :class:`~repro_torch.analysis.model.RepoModel`
(parsed ASTs plus cheap cross-module indexes) and emit :class:`Finding`
objects.

Suppression
-----------
A finding is suppressed by a comment on the same line or the line above::

    x = float(loss)  # analysis: ignore[trace-purity] -- host-side metric

Multiple rule ids may be listed comma-separated.  ``ignore[*]`` suppresses
every rule on that line.  The rule ids are those of ``repro.analysis``, so
a comment in a port file mutes the reference's rule of that id there too.

Fingerprints
------------
Baseline entries match findings by a line-insensitive fingerprint
(rule id + path + normalized message), so unrelated edits that shift line
numbers do not invalidate the baseline.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Callable, Dict, List, Optional

SUPPRESS_RE = re.compile(r"#\s*analysis:\s*ignore\[([^\]]*)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int  # 1-based; 0 for whole-file findings
    message: str

    @property
    def fingerprint(self) -> str:
        norm = re.sub(r"\s+", " ", self.message.strip())
        raw = f"{self.rule}::{self.path}::{norm}"
        return hashlib.sha256(raw.encode("utf-8")).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered analysis rule."""

    id: str
    description: str
    check: Callable  # (RepoModel) -> List[Finding]


_REGISTRY: Dict[str, Rule] = {}


def register(rule_id: str, description: str):
    """Decorator: register ``check(model) -> [Finding]`` under ``rule_id``."""

    def deco(fn):
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate rule id: {rule_id}")
        _REGISTRY[rule_id] = Rule(rule_id, description, fn)
        return fn

    return deco


def all_rules() -> List[Rule]:
    # Import for side effect: rule modules self-register on first use.
    from repro_torch.analysis import rules as _rules  # noqa: F401

    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    from repro_torch.analysis import rules as _rules  # noqa: F401

    if rule_id not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown rule {rule_id!r} (known: {known})")
    return _REGISTRY[rule_id]


def suppressed_rules(lines: List[str], line: int) -> Optional[set]:
    """Rule ids suppressed at 1-based ``line`` (same line or line above)."""
    out: set = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(lines):
            m = SUPPRESS_RE.search(lines[ln - 1])
            if m:
                out.update(p.strip() for p in m.group(1).split(",") if p.strip())
    return out


def is_suppressed(finding: Finding, lines: List[str]) -> bool:
    sup = suppressed_rules(lines, finding.line)
    return bool(sup) and (finding.rule in sup or "*" in sup)
