"""Committed-baseline handling for the analysis pass.

The baseline file (``analysis-baseline-torch.json`` at the repo root) records
deliberately-accepted findings by fingerprint, each with a one-line
justification.  The CI gate fails only on findings *not* in the baseline,
and reports baseline entries that no longer match anything (stale entries
must be pruned so the file never accretes dead exceptions).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis.base import Finding

BASELINE_NAME = "analysis-baseline-torch.json"


def load_baseline(root) -> Dict[str, str]:
    """fingerprint -> justification; empty dict when no baseline exists."""
    path = Path(root) / BASELINE_NAME
    if not path.is_file():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    out: Dict[str, str] = {}
    for entry in data.get("findings", []):
        fp = entry["fingerprint"]
        just = entry.get("justification", "")
        if not just:
            raise ValueError(
                f"{BASELINE_NAME}: entry {fp} has no justification; every "
                "baseline exception must say why it is deliberate"
            )
        out[fp] = just
    return out


def save_baseline(root, findings: List[Finding], justifications=None) -> Path:
    """Write findings as the new baseline (used by ``--update-baseline``)."""
    justifications = justifications or {}
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line)):
        entries.append(
            {
                "rule": f.rule,
                "path": f.path,
                "message": f.message,
                "fingerprint": f.fingerprint,
                "justification": justifications.get(
                    f.fingerprint, "TODO: justify or fix"
                ),
            }
        )
    path = Path(root) / BASELINE_NAME
    path.write_text(
        json.dumps({"version": 1, "findings": entries}, indent=2) + "\n",
        encoding="utf-8",
    )
    return path


def split_by_baseline(
    findings: List[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(new, accepted, stale_fingerprints)."""
    seen = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    accepted = [f for f in findings if f.fingerprint in baseline]
    stale = sorted(fp for fp in baseline if fp not in seen)
    return new, accepted, stale
