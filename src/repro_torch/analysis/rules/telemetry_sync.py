"""telemetry-host-sync: device values cross to the host only at flush.

Contract (docs/INVARIANTS_TORCH.md §7): the port's telemetry folds the
host values each phase reads anyway and flushes once per phase. A stray
host round-trip inside the telemetry modules — ``float()`` / ``int()``
coercion, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, or a numpy
``asarray`` / ``array`` materialization of a tensor — would silently add
a device sync per step without failing any numerics test.

Structurally: in every module under ``src/repro_torch/telemetry/`` that
imports torch, those calls are only legal inside the flush functions
registered in ``FLUSH_FUNCTIONS`` (``src/repro_torch/telemetry/metrics.py``).
Modules that never import torch (the numpy accumulator, the report
renderer, which only reads JSON) hold host values by definition and are
out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.base import Finding, register
from repro_torch.analysis.model import ModuleInfo, RepoModel, dotted_call_name

RULE_ID = "telemetry-host-sync"
SCOPE_PREFIX = "src/repro_torch/telemetry/"
METRICS_MODULE = "src/repro_torch/telemetry/metrics.py"
# Host coercions of a (possibly device-resident) scalar.
COERCION_NAMES = ("float", "int")
# Tensor methods that copy to the host.
HOST_METHODS = ("item", "tolist", "cpu", "numpy")
# Numpy materializations of a device tensor.
NUMPY_MATERIALIZERS = ("asarray", "array", "asanyarray")


def _flush_registry(model: RepoModel) -> Optional[Set[str]]:
    """The FLUSH_FUNCTIONS tuple parsed from the metrics module's AST
    (the model's constant index only carries scalars), or None when the
    registry is missing/malformed."""
    mod = model.find(METRICS_MODULE)
    if mod is None:
        return None
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and tgt.id == "FLUSH_FUNCTIONS"):
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List)):
            return None
        names: Set[str] = set()
        for elt in node.value.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            names.add(elt.value)
        return names
    return None


def _imports_torch(mod: ModuleInfo) -> bool:
    return any(origin == "torch" or origin.startswith("torch.")
               for origin in mod.imports.values())


def _violation(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    """Why this call is a host round-trip, or None."""
    func = call.func
    if isinstance(func, ast.Name) and func.id in COERCION_NAMES:
        return (f"`{func.id}()` coerces to a host scalar (a device sync "
                "on a card tensor)")
    if isinstance(func, ast.Attribute):
        if func.attr in HOST_METHODS:
            return f"`.{func.attr}()` is a host round-trip"
        if func.attr in NUMPY_MATERIALIZERS:
            root = func.value
            while isinstance(root, ast.Attribute):
                root = root.value
            if (isinstance(root, ast.Name)
                    and mod.imports.get(root.id) == "numpy"):
                return (f"numpy `.{func.attr}()` materializes a device "
                        "tensor on the host")
    return None


@register(RULE_ID, "telemetry host round-trips only in registered flush "
                   "functions")
def check(model: RepoModel) -> List[Finding]:
    in_scope = [m for m in model.src_modules()
                if m.rel.startswith(SCOPE_PREFIX) and _imports_torch(m)]
    if not in_scope and model.find(METRICS_MODULE) is None:
        return []

    findings: List[Finding] = []
    flush = _flush_registry(model)
    if flush is None:
        findings.append(Finding(
            RULE_ID, METRICS_MODULE, 1,
            "FLUSH_FUNCTIONS registry missing or not a literal tuple of "
            "function-name strings — the rule cannot whitelist flush "
            "sites without it"))
        flush = set()
    else:
        metrics = model.find(METRICS_MODULE)
        defined = {qn.rsplit(".", 1)[-1] for qn in metrics.functions}
        for name in sorted(flush - defined):
            findings.append(Finding(
                RULE_ID, METRICS_MODULE, 1,
                f"FLUSH_FUNCTIONS names {name!r}, which is not defined "
                "in the metrics module — stale registry entries hide "
                "real violations"))

    for mod in in_scope:
        exempt_calls = set()
        for qn, fi in mod.functions.items():
            if qn.rsplit(".", 1)[-1] in flush:
                exempt_calls.update(
                    id(n) for n in ast.walk(fi.node)
                    if isinstance(n, ast.Call))
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or id(node) in exempt_calls:
                continue
            why = _violation(mod, node)
            if why:
                name = dotted_call_name(node.func) or "<call>"
                findings.append(Finding(
                    RULE_ID, mod.rel, node.lineno,
                    f"{why} — telemetry folds host values and flushes "
                    "once per phase; move this into a "
                    "FLUSH_FUNCTIONS-registered flush function "
                    f"(call: {name})"))
    return findings
