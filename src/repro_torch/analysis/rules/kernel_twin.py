"""kernel-twin: every Hopper kernel has a registered plain PyTorch twin.

Contract (docs/INVARIANTS_TORCH.md §3): each hand-written kernel under
``src/repro_torch/kernels/`` must have a plain PyTorch twin in
``kernels/ref.py`` — the twin is the semantics; the kernel is the fast
path — plus an equivalence test among the port's tests and a sweep of
``kernels/card_check.py`` that holds it on the card. The mapping is
explicit: ``ref.py`` exports a ``TWINS`` dict literal mapping kernel name
to twin name(s).

A kernel is a public module-level function of a module under
``kernels/`` that reaches ``_build.library("<name>")`` through calls
within the same module (``avg_disp`` -> ``_card_avg`` -> ``_avg_launch``
-> ``_build.library("avg_disp")``).

Checks (the reference's five):
  * a kernel with no ``TWINS`` entry -> finding;
  * a ``TWINS`` entry whose twin is not defined in ``ref.py`` -> finding;
  * a stale ``TWINS`` key naming no discovered kernel -> finding;
  * twin-signature drift: every kernel parameter (minus launch-only
    parameters in ``EXEMPT_PARAMS``) must appear in the union of its
    twins' signatures -> finding;
  * no test module mentioning both the kernel and one of its twins
    -> finding.
And three on the port's terms:
  * a library name a kernel reaches with no entry in
    ``_build.SIGNATURES`` (the ctypes signature of its entry point)
    -> finding;
  * a library name with no ``csrc/<name>.cu`` source -> finding;
  * no function of ``kernels/card_check.py`` naming both the kernel and
    one of its twins (the sweep that holds it on the card) -> finding.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import Finding, register
from repro_torch.analysis.model import ModuleInfo, RepoModel, dotted_call_name

RULE_ID = "kernel-twin"
BUILD_ORIGIN = "repro_torch.kernels._build"

# Launch-geometry / dispatch parameters that have no meaning for a twin.
EXEMPT_PARAMS = {
    "block_p", "block_m", "block_q", "block_k", "block_s", "block_w",
    "interpret", "mode",
}

def _param_names(fn: ast.AST) -> Set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def _is_build_library(mod: ModuleInfo, func: ast.AST) -> bool:
    """``_build.library`` (or ``library`` imported from ``_build``)."""
    name = dotted_call_name(func)
    if name is None:
        return False
    parts = name.split(".")
    head = mod.imports.get(parts[0], parts[0])
    return ".".join([head] + parts[1:]) == f"{BUILD_ORIGIN}.library"


def _direct_libraries(mod: ModuleInfo, fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and _is_build_library(mod, node.func)
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value)
    return out


def _local_callees(mod: ModuleInfo, fn: ast.AST) -> Set[str]:
    """Module-level functions of ``mod`` that ``fn`` calls by name."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in mod.functions and "." not in node.func.id:
                out.add(node.func.id)
    return out


def kernel_libraries(mod: ModuleInfo, qualname: str) -> Set[str]:
    """Library names ``qualname`` reaches through same-module calls."""
    seen: Set[str] = set()
    stack = [qualname]
    libs: Set[str] = set()
    while stack:
        qn = stack.pop()
        if qn in seen:
            continue
        seen.add(qn)
        fn = mod.functions[qn].node
        libs |= _direct_libraries(mod, fn)
        stack.extend(_local_callees(mod, fn) - seen)
    return libs


def discover_kernels(model: RepoModel) -> List[Tuple[ModuleInfo, str, ast.AST]]:
    """Public module-level defs under kernels/ that reach a CUDA library."""
    out = []
    for mod in model.src_modules():
        if "/kernels/" not in mod.rel:
            continue
        if mod.rel.endswith(("/ref.py", "/__init__.py")):
            continue
        for qn, fi in sorted(mod.functions.items()):
            if "." in qn or qn.startswith("_"):
                continue
            if kernel_libraries(mod, qn):
                out.append((mod, qn, fi.node))
    return out


def _dict_literal(mod: ModuleInfo, name: str):
    """(assign_line, ast.Dict | None) of module-level ``name = {...}``;
    (0, None) when ``name`` is not assigned."""
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Name) and t.id == name):
            continue
        if not isinstance(node.value, ast.Dict):
            return node.lineno, None
        return node.lineno, node.value
    return 0, None


def _twins_table(ref: ModuleInfo):
    """(assign_line, {kernel: [twin, ...]}) from the TWINS dict literal."""
    line, lit = _dict_literal(ref, "TWINS")
    if lit is None:
        return line, None
    table: Dict[str, List[str]] = {}
    for k, v in zip(lit.keys, lit.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            continue
        names: List[str] = []
        vals = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
        for e in vals:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                names.append(e.value)
        table[k.value] = names
    return line, table


def _signature_keys(build: Optional[ModuleInfo]) -> Optional[Set[str]]:
    """The string keys of ``_build.SIGNATURES``, or None when missing."""
    if build is None:
        return None
    _, lit = _dict_literal(build, "SIGNATURES")
    if lit is None:
        return None
    return {k.value for k in lit.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _identifiers(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for a in n.names:
                out.add((a.asname or a.name).split(".")[-1])
    return out


def _card_check_functions(card: Optional[ModuleInfo]) -> List[Set[str]]:
    if card is None:
        return []
    return [_identifiers(fi.node) for fi in card.functions.values()]


@register(RULE_ID, "every CUDA kernel has a ref.py twin, a test and a card sweep")
def check(model: RepoModel) -> List[Finding]:
    kernels = discover_kernels(model)
    if not kernels:
        return []
    ref = model.find("kernels/ref.py")
    if ref is None:
        mod = kernels[0][0]
        return [
            Finding(
                RULE_ID,
                mod.rel,
                0,
                "kernels/ref.py is missing: CUDA kernels have no plain twins",
            )
        ]
    twins_line, table = _twins_table(ref)
    if table is None:
        return [
            Finding(
                RULE_ID,
                ref.rel,
                twins_line,
                "kernels/ref.py must define a TWINS dict literal mapping "
                "each CUDA kernel to its plain PyTorch twin(s)",
            )
        ]

    findings: List[Finding] = []
    ref_defs = {qn for qn in ref.functions if "." not in qn}
    test_ids = {m.rel: _identifiers(m.tree) for m in model.test_modules()}
    kernel_names = {qn for _, qn, _ in kernels}
    build = model.find("kernels/_build.py")
    signatures = _signature_keys(build)
    card_fns = _card_check_functions(model.find("kernels/card_check.py"))

    for mod, name, fn in kernels:
        for lib in sorted(kernel_libraries(mod, name)):
            if signatures is None or lib not in signatures:
                findings.append(
                    Finding(
                        RULE_ID,
                        mod.rel,
                        fn.lineno,
                        f"kernel `{name}` loads library `{lib}`, which has "
                        "no entry in kernels/_build.py SIGNATURES",
                    )
                )
            if not (mod.path.parent / "csrc" / f"{lib}.cu").is_file():
                findings.append(
                    Finding(
                        RULE_ID,
                        mod.rel,
                        fn.lineno,
                        f"kernel `{name}` loads library `{lib}`, which has "
                        f"no source kernels/csrc/{lib}.cu",
                    )
                )
        if name not in table:
            findings.append(
                Finding(
                    RULE_ID,
                    mod.rel,
                    fn.lineno,
                    f"CUDA kernel `{name}` has no TWINS entry in "
                    "kernels/ref.py (register its plain twin)",
                )
            )
            continue
        twin_names = table[name]
        missing = [t for t in twin_names if t not in ref_defs]
        for t in missing:
            findings.append(
                Finding(
                    RULE_ID,
                    ref.rel,
                    twins_line,
                    f"TWINS maps `{name}` to `{t}`, which is not defined in "
                    "kernels/ref.py",
                )
            )
        present = [t for t in twin_names if t in ref_defs]
        if present:
            twin_params: Set[str] = set()
            for t in present:
                twin_params |= _param_names(ref.functions[t].node)
            drift = sorted(_param_names(fn) - twin_params - EXEMPT_PARAMS)
            if drift:
                findings.append(
                    Finding(
                        RULE_ID,
                        mod.rel,
                        fn.lineno,
                        f"twin-signature drift: kernel `{name}` parameters "
                        f"{drift} missing from twin(s) {present}",
                    )
                )
        covered = any(
            name in ids and any(t in ids for t in twin_names)
            for ids in test_ids.values()
        )
        if not covered:
            findings.append(
                Finding(
                    RULE_ID,
                    mod.rel,
                    fn.lineno,
                    f"no equivalence test references kernel `{name}` together "
                    f"with twin(s) {twin_names} under tests/",
                )
            )
        swept = any(
            name in ids and any(t in ids for t in twin_names)
            for ids in card_fns
        )
        if not swept:
            findings.append(
                Finding(
                    RULE_ID,
                    mod.rel,
                    fn.lineno,
                    f"no function of kernels/card_check.py names kernel "
                    f"`{name}` together with twin(s) {twin_names}: nothing "
                    "holds it against its twin on the card",
                )
            )

    for key in sorted(table):
        if key not in kernel_names:
            findings.append(
                Finding(
                    RULE_ID,
                    ref.rel,
                    twins_line,
                    f"stale TWINS entry `{key}`: no CUDA kernel of that "
                    "name found under kernels/",
                )
            )
    return findings
