"""eager-validation: public entry points validate before they run.

Contract (docs/INVARIANTS_TORCH.md §5): configuration errors must surface
as eager Python exceptions at construction/parse time, never as shape
errors three layers into a step or as a failed kernel launch.  Each
registered entry point (constructor class or function) must contain at
least one ``raise ValueError`` /
``raise TypeError`` — directly, or one call deep into a same-module
helper.  ``train.main`` may equivalently use ``argparse``'s
``parser.error(...)``.

The registry below names the port's entry points, the reference's seven
in the port's files; on trees where a registered file does not exist the
entry is skipped, so the rule also works on the miniature fixture trees
used by tests/test_torch_analysis.py.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.base import Finding, register
from repro_torch.analysis.model import ModuleInfo, RepoModel

RULE_ID = "eager-validation"

# (module rel-path suffix, class name or function name)
ENTRY_POINTS = (
    ("core/averaging.py", "AveragingSchedule"),
    ("core/compress.py", "Compression"),
    ("topology.py", "Topology"),
    ("faults.py", "FaultPlan"),
    ("elastic.py", "ElasticPlan"),
    ("core/engine.py", "PhaseEngine"),
    ("launch/train.py", "main"),
)

_EAGER_EXC = {"ValueError", "TypeError", "KeyError", "NotImplementedError"}


def _raises_eagerly(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Raise) and node.exc is not None:
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in _EAGER_EXC:
                return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "error":  # argparse parser.error(...)
                return True
    return False


def _validates(mod: ModuleInfo, fn: ast.AST) -> bool:
    """Direct raise, or a call into a same-module function that raises."""
    if _raises_eagerly(fn):
        return True
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee: Optional[str] = None
        if isinstance(node.func, ast.Name):
            callee = node.func.id
        elif isinstance(node.func, ast.Attribute) and isinstance(
            node.func.value, ast.Name
        ) and node.func.value.id in ("self", "cls"):
            callee = node.func.attr
        if callee is None:
            continue
        for qn, fi in mod.functions.items():
            if qn.rsplit(".", 1)[-1] == callee and _raises_eagerly(fi.node):
                return True
    return False


def _class_validates(mod: ModuleInfo, cls_name: str) -> bool:
    methods = [
        fi
        for qn, fi in mod.functions.items()
        if fi.cls == cls_name
    ]
    return any(_validates(mod, fi.node) for fi in methods)


@register(RULE_ID, "entry points raise on bad config before any step runs")
def check(model: RepoModel) -> List[Finding]:
    findings: List[Finding] = []
    for suffix, name in ENTRY_POINTS:
        mod = model.find(suffix)
        if mod is None:
            continue
        cls = None
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == name:
                cls = node
                break
        if cls is not None:
            if not _class_validates(mod, name):
                findings.append(
                    Finding(
                        RULE_ID,
                        mod.rel,
                        cls.lineno,
                        f"entry point `{name}` performs no eager validation: "
                        "no method raises ValueError/TypeError on bad "
                        "configuration before tracing",
                    )
                )
            continue
        fi = mod.functions.get(name)
        if fi is None:
            findings.append(
                Finding(
                    RULE_ID,
                    mod.rel,
                    0,
                    f"registered entry point `{name}` not found in {suffix}",
                )
            )
            continue
        if not _validates(mod, fi.node):
            findings.append(
                Finding(
                    RULE_ID,
                    mod.rel,
                    fi.node.lineno,
                    f"entry point `{name}` performs no eager validation "
                    "(expected raise ValueError/TypeError or parser.error)",
                )
            )
    return findings
