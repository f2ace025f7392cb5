"""rng-salt: every ``repro_torch.rng.fold_in`` stream must be uniquely salted.

Contract (docs/INVARIANTS_TORCH.md §2): bit-reproducible replay hangs off
pure ``fold_in`` streams derived from the decision key, drawn through the
port's threefry (``repro_torch.rng``, bitwise ``jax.random``). Each
subsystem owns a distinct module-level salt constant (``_GOSSIP_SALT``,
``_ENC_SALT``, ``_STRAGGLE_SALT``, ...); two call sites folding the same
``(key, salt)`` chain would draw correlated randomness (topology events
correlated with quantization rounding, say) and silently bias Eq. 4
dispersion traces.

Calls are resolved through each module's imports, as the reference
resolves ``jax.random``: ``rng.fold_in`` after ``from repro_torch import
rng`` counts, and so does a bare ``fold_in`` / ``split`` inside
``repro_torch/rng.py`` itself.

Checks:
  * registry: every ``fold_in`` site is collected with its resolved salt
    chain (exposed as :func:`registry` for tests/tooling);
  * two *stream heads* (outermost folds) in different locations with an
    identical resolved chain -> finding;
  * two ``*_SALT`` module constants sharing a value -> finding;
  * a raw key used again in a ``repro_torch.rng.*`` call after being
    consumed by ``repro_torch.rng.split`` without rebinding -> finding.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Tuple

from repro_torch.analysis.base import Finding, register
from repro_torch.analysis.model import ModuleInfo, RepoModel, dotted_call_name

RULE_ID = "rng-salt"
SALT_NAME_RE = re.compile(r"(^|_)SALT$")
_MAX_CHAIN = 8
RNG_MODULE = "repro_torch.rng"
RNG_REL = "src/repro_torch/rng.py"


def _resolve_dotted(mod: ModuleInfo, name: str) -> str:
    parts = name.split(".")
    head = mod.imports.get(parts[0])
    if head is None and mod.rel == RNG_REL and len(parts) == 1 \
            and parts[0] in mod.functions:
        head = f"{RNG_MODULE}.{parts[0]}"  # the rng module's own draws
    return ".".join([head or parts[0]] + parts[1:])


def _is_rng(mod: ModuleInfo, func: ast.AST, leaf: str) -> bool:
    name = dotted_call_name(func)
    if name is None:
        return False
    return _resolve_dotted(mod, name) == f"{RNG_MODULE}.{leaf}"


@dataclasses.dataclass
class FoldSite:
    mod: ModuleInfo
    qualname: str  # enclosing function ('' = module level)
    node: ast.Call
    chain: Tuple  # (("root", name), ("const", v) | "VAR", ...)
    is_head: bool

    @property
    def line(self) -> int:
        return self.node.lineno

    def describe(self) -> str:
        parts = []
        for el in self.chain:
            if isinstance(el, tuple) and el[0] == "root":
                parts.append(f"root={el[1]}")
            elif isinstance(el, tuple) and el[0] == "const":
                parts.append(hex(el[1]) if isinstance(el[1], int) else repr(el[1]))
            else:
                parts.append("<var>")
        return " -> ".join(parts)


def _scopes(mod: ModuleInfo):
    """(qualname, body-statements) for module level and each function."""
    yield "", mod.tree
    for qn, fi in mod.functions.items():
        yield qn, fi.node


def _own_calls(scope_node: ast.AST):
    # Nested defs are their own scopes, but lambda bodies (per-row draws)
    # stay in the enclosing scope: they cannot rebind names.
    stack = list(ast.iter_child_nodes(scope_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _single_assignments(scope_node: ast.AST) -> Dict[str, ast.AST]:
    """name -> value expr, for names assigned exactly once in this scope."""
    counts: Dict[str, int] = {}
    values: Dict[str, ast.AST] = {}
    stack = list(ast.iter_child_nodes(scope_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            t = n.targets[0]
            if isinstance(t, ast.Name):
                counts[t.id] = counts.get(t.id, 0) + 1
                values[t.id] = n.value
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign, ast.For)):
            tgt = getattr(n, "target", None)
            if isinstance(tgt, ast.Name):
                counts[tgt.id] = counts.get(tgt.id, 0) + 99
        stack.extend(ast.iter_child_nodes(n))
    return {k: v for k, v in values.items() if counts.get(k) == 1}


def _collect_sites(model: RepoModel, mod: ModuleInfo) -> List[FoldSite]:
    sites: List[FoldSite] = []
    for qn, scope in _scopes(mod):
        assigns = _single_assignments(scope)
        fold_calls = [
            c for c in _own_calls(scope) if _is_rng(mod, c.func, "fold_in")
        ]
        consumed = set()
        for c in fold_calls:
            if c.args and isinstance(c.args[0], ast.Call):
                consumed.add(id(c.args[0]))

        def classify(expr) -> object:
            if isinstance(expr, ast.Constant) and isinstance(expr.value, (int, str)):
                return ("const", expr.value)
            if isinstance(expr, ast.Name):
                val = model.resolve_constant(mod, expr.id)
                if val is not None and isinstance(val, (int, str)):
                    return ("const", val)
            return "VAR"

        def chain_of(call: ast.Call, depth: int) -> Tuple:
            salt = classify(call.args[1]) if len(call.args) > 1 else "VAR"
            base = call.args[0] if call.args else None
            if depth < _MAX_CHAIN and isinstance(base, ast.Call) and _is_rng(
                mod, base.func, "fold_in"
            ):
                return chain_of(base, depth + 1) + (salt,)
            if depth < _MAX_CHAIN and isinstance(base, ast.Name):
                sub = assigns.get(base.id)
                if (
                    isinstance(sub, ast.Call)
                    and _is_rng(mod, sub.func, "fold_in")
                    and base.id not in {n.id for n in ast.walk(sub) if isinstance(n, ast.Name)}
                ):
                    return chain_of(sub, depth + 1) + (salt,)
            root = ast.unparse(base) if base is not None else "?"
            return (("root", root), salt)

        for c in fold_calls:
            sites.append(
                FoldSite(
                    mod=mod,
                    qualname=qn,
                    node=c,
                    chain=chain_of(c, 0),
                    is_head=id(c) not in consumed,
                )
            )
    return sites


def registry(model: RepoModel) -> List[FoldSite]:
    """Every fold_in site across src/, with resolved salt chains."""
    out: List[FoldSite] = []
    for mod in model.src_modules():
        out.extend(_collect_sites(model, mod))
    return out


def _normalize(site: FoldSite) -> Tuple:
    """Signature used for collision grouping.

    Roots keep their source name (``key`` vs ``dec_key`` are distinct
    streams by convention); salts keep resolved constants; everything
    else collapses to VAR.
    """
    out = []
    for el in site.chain:
        if isinstance(el, tuple):
            out.append(el)
        else:
            out.append("VAR")
    return tuple(out)


def _check_split_reuse(mod: ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    for qn, scope in _scopes(mod):
        events: List[Tuple[int, int, str, str]] = []  # (line, prio, kind, name)
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Call) and dotted_call_name(n.func):
                resolved = _resolve_dotted(mod, dotted_call_name(n.func))
                if resolved.startswith(f"{RNG_MODULE}."):
                    is_split = resolved == f"{RNG_MODULE}.split"
                    for i, a in enumerate(n.args):
                        if not isinstance(a, ast.Name):
                            continue
                        if is_split and i == 0:
                            events.append((n.lineno, 1, "split", a.id))
                        else:
                            events.append((n.lineno, 0, "use", a.id))
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                    for e in elts:
                        if isinstance(e, ast.Name):
                            events.append((n.lineno, 2, "assign", e.id))
            stack.extend(ast.iter_child_nodes(n))
        state: Dict[str, str] = {}
        for line, _prio, kind, name in sorted(events):
            if kind == "use" and state.get(name) == "spent":
                findings.append(
                    Finding(
                        RULE_ID,
                        mod.rel,
                        line,
                        f"{qn or '<module>'}: raw key `{name}` used after "
                        f"`rng.split({name})` without rebinding",
                    )
                )
                state[name] = "flagged"
            elif kind == "split":
                if state.get(name) != "flagged":
                    state[name] = "spent"
            elif kind == "assign":
                state[name] = "fresh"
    return findings


@register(RULE_ID, "unique fold_in salt streams; no raw-key reuse after split")
def check(model: RepoModel) -> List[Finding]:
    findings: List[Finding] = []

    # 1. salt-constant value uniqueness across src/
    salts: Dict[object, Tuple[str, str]] = {}
    for mod in model.src_modules():
        for name, val in mod.constants.items():
            if SALT_NAME_RE.search(name) and isinstance(val, int):
                prev = salts.get(val)
                if prev is not None and prev[1] != name:
                    findings.append(
                        Finding(
                            RULE_ID,
                            mod.rel,
                            0,
                            f"salt constant {name}={hex(val)} duplicates "
                            f"{prev[1]} in {prev[0]}; streams would collide",
                        )
                    )
                else:
                    salts.setdefault(val, (mod.rel, name))

    # 2. stream-head collisions
    heads = [s for s in registry(model) if s.is_head]
    groups: Dict[Tuple, List[FoldSite]] = {}
    for s in heads:
        groups.setdefault(_normalize(s), []).append(s)
    for sig, sites in groups.items():
        distinct = {(s.mod.rel, s.line) for s in sites}
        if len(distinct) < 2:
            continue
        first = min(sites, key=lambda s: (s.mod.rel, s.line))
        for s in sites:
            if (s.mod.rel, s.line) == (first.mod.rel, first.line):
                continue
            findings.append(
                Finding(
                    RULE_ID,
                    s.mod.rel,
                    s.line,
                    f"{s.qualname or '<module>'}: fold_in stream "
                    f"[{s.describe()}] collides with "
                    f"{first.mod.rel}:{first.qualname or '<module>'} "
                    f"(identical (key, salt) chain)",
                )
            )

    # 3. raw key reuse after split
    for mod in model.src_modules():
        findings.extend(_check_split_reuse(mod))
    return findings
