"""checkpoint-ladder: the v0..vN loader ladder must stay complete.

Contract (docs/INVARIANTS_TORCH.md §4): the port's
``src/repro_torch/checkpoint/io.py`` owns
``ENGINE_STATE_VERSION`` (= N).  Every historical version ``0..N-1`` must
keep an explicit loader branch in ``load_engine_state`` (``version == k``
or ``version in (..k..)``; the latest version may be the fall-through),
there must be a future-version refusal (``version > ENGINE_STATE_VERSION``
raising), the ``EngineState`` fields with defaults must equal
``_OPTIONAL_FIELDS``, every ``EngineState`` field must be handled
somewhere in io.py, and tests must round-trip each historical version.
The checks are the reference's, read on the port's ``checkpoint/io.py``,
the port's ``EngineState`` (``core/engine.py``) and the port's tests.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from repro_torch.analysis.base import Finding, register
from repro_torch.analysis.model import ModuleInfo, RepoModel

RULE_ID = "checkpoint-ladder"


def _namedtuple_fields(cls: ast.ClassDef):
    """[(name, has_default)] for a NamedTuple class body."""
    out = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.append((node.target.id, node.value is not None))
    return out


def _find_class(mod: ModuleInfo, name: str) -> Optional[ast.ClassDef]:
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _version_compare_ints(fn: ast.AST, version_names: Set[str]) -> Set[int]:
    """Ints k appearing as ``<ver> == k`` / ``<ver> in (..k..)`` in fn."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        if not any(
            isinstance(s, ast.Name) and s.id in version_names for s in sides
        ):
            continue
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, ast.Eq):
                if isinstance(comp, ast.Constant) and isinstance(comp.value, int):
                    out.add(comp.value)
                if isinstance(node.left, ast.Constant) and isinstance(
                    node.left.value, int
                ):
                    out.add(node.left.value)
            elif isinstance(op, ast.In) and isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                for e in comp.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value, int):
                        out.add(e.value)
    return out


def _has_future_guard(fn: ast.AST, version_names: Set[str], const_name: str) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if not isinstance(test, ast.Compare) or len(test.ops) != 1:
            continue
        lhs, op, rhs = test.left, test.ops[0], test.comparators[0]
        pair_gt = (
            isinstance(op, ast.Gt)
            and isinstance(lhs, ast.Name)
            and lhs.id in version_names
            and isinstance(rhs, ast.Name)
            and rhs.id == const_name
        )
        pair_lt = (
            isinstance(op, ast.Lt)
            and isinstance(rhs, ast.Name)
            and rhs.id in version_names
            and isinstance(lhs, ast.Name)
            and lhs.id == const_name
        )
        if (pair_gt or pair_lt) and any(
            isinstance(n, ast.Raise) for n in ast.walk(node)
        ):
            return True
    return False


def _test_version_literals(model: RepoModel) -> Set[int]:
    """Version ints test modules exercise.

    Evidence accepted, in any test module: a dict literal entry keyed by
    ``"engine_state_version"``; a ``version=``/``engine_state_version=``
    keyword argument; an equality comparison whose other side mentions
    the version key; or a ``test_*v<k>*`` test-function name in a module
    that references the version key (v1 is *defined* by the absence of a
    version field, so only a named test can witness it). The port's tests
    parametrize over the ladder, so in such a module a string constant
    naming ``v<k>`` as a ``-`` / ``_``-separated token (a pytest id
    ``"v3"``, a case ``"int8-v3"``) witnesses ``k`` the same way.
    """
    out: Set[int] = set()
    name_re = re.compile(r"(?:^|_)v(\d+)(?:_|$)")
    id_re = re.compile(r"(?:^|[_-])v(\d+)(?:[_-]|$)")
    for mod in model.test_modules():
        mentions_key = any(
            isinstance(n, ast.Constant) and n.value == "engine_state_version"
            for n in ast.walk(mod.tree)
        )
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (
                        isinstance(k, ast.Constant)
                        and k.value == "engine_state_version"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, int)
                    ):
                        out.add(v.value)
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in ("version", "engine_state_version") and isinstance(
                        kw.value, ast.Constant
                    ) and isinstance(kw.value.value, int):
                        out.add(kw.value.value)
            elif isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                texts = [ast.unparse(s) for s in sides]
                if any("engine_state_version" in t for t in texts):
                    for s in sides:
                        if isinstance(s, ast.Constant) and isinstance(s.value, int):
                            out.add(s.value)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if mentions_key and node.name.startswith("test"):
                    for m in name_re.finditer(node.name):
                        out.add(int(m.group(1)))
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                if mentions_key:
                    for m in id_re.finditer(node.value):
                        out.add(int(m.group(1)))
    return out


@register(RULE_ID, "complete v0..vN checkpoint loader ladder + field coverage")
def check(model: RepoModel) -> List[Finding]:
    io = model.find("checkpoint/io.py")
    if io is None:
        return []  # nothing to check on trees without the checkpoint layer
    findings: List[Finding] = []

    latest = io.constants.get("ENGINE_STATE_VERSION")
    if not isinstance(latest, int):
        return [
            Finding(
                RULE_ID,
                io.rel,
                0,
                "checkpoint/io.py must define an integer "
                "ENGINE_STATE_VERSION module constant",
            )
        ]

    load = io.functions.get("load_engine_state")
    if load is None:
        return [
            Finding(RULE_ID, io.rel, 0, "load_engine_state is missing from checkpoint/io.py")
        ]
    version_names = {"version", "ver", "v"}
    covered = _version_compare_ints(load.node, version_names)
    missing = sorted(set(range(latest)) - covered)
    for k in missing:
        findings.append(
            Finding(
                RULE_ID,
                io.rel,
                load.node.lineno,
                f"load_engine_state has no loader branch for layout "
                f"version {k} (ladder must cover v0..v{latest - 1} "
                f"explicitly; v{latest} may be the fall-through)",
            )
        )
    if not _has_future_guard(load.node, version_names, "ENGINE_STATE_VERSION"):
        findings.append(
            Finding(
                RULE_ID,
                io.rel,
                load.node.lineno,
                "load_engine_state must refuse payloads with version > "
                "ENGINE_STATE_VERSION (raise on unknown future layouts)",
            )
        )

    # EngineState field coverage.
    eng = model.find("core/engine.py")
    cls = _find_class(eng, "EngineState") if eng else None
    if cls is not None:
        fields = _namedtuple_fields(cls)
        optional = tuple(n for n, has_default in fields if has_default)
        declared = io.tree.body
        opt_const: Optional[tuple] = None
        for node in declared:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and t.id == "_OPTIONAL_FIELDS":
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        opt_const = tuple(
                            e.value
                            for e in node.value.elts
                            if isinstance(e, ast.Constant)
                        )
        if opt_const is None:
            findings.append(
                Finding(
                    RULE_ID,
                    io.rel,
                    0,
                    "checkpoint/io.py must declare _OPTIONAL_FIELDS naming "
                    "the EngineState fields with defaults",
                )
            )
        elif set(opt_const) != set(optional):
            findings.append(
                Finding(
                    RULE_ID,
                    io.rel,
                    0,
                    f"_OPTIONAL_FIELDS {sorted(opt_const)} does not match "
                    f"EngineState defaulted fields {sorted(optional)}; the "
                    "ladder no longer maps the latest layout",
                )
            )
        io_idents: Set[str] = set()
        for node in ast.walk(io.tree):
            if isinstance(node, ast.Attribute):
                io_idents.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                io_idents.add(node.value)
            elif isinstance(node, ast.Name):
                io_idents.add(node.id)
        # io.py may (and does) serialize the state generically — pytree
        # flatten plus NamedTuple._replace — in which case per-field
        # coverage is structural, not textual.
        generic = io_idents & {"_replace", "_asdict", "_fields"}
        if not generic:
            for name, _ in fields:
                if name not in io_idents:
                    findings.append(
                        Finding(
                            RULE_ID,
                            io.rel,
                            0,
                            f"EngineState field `{name}` is never referenced "
                            "in checkpoint/io.py; the latest layout does not "
                            "map the full state",
                        )
                    )

    # Round-trip test coverage for historical versions.
    if model.test_modules():
        tested = _test_version_literals(model)
        untested = sorted(set(range(latest)) - tested)
        if untested:
            findings.append(
                Finding(
                    RULE_ID,
                    io.rel,
                    0,
                    f"no test constructs layout version(s) {untested} "
                    "(expected a round-trip test per historical version)",
                )
            )
    return findings
