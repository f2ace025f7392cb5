"""jit-cache-hygiene: the port's tests keep the cache convention and
touch no card at import time.

Contract (docs/INVARIANTS_TORCH.md §6): the port's tests also run the JAX
reference, for parity, so the reference's convention holds for them:
``tests/conftest.py`` owns a module-scoped autouse fixture that calls
``jax.clear_caches()`` after every test module, and no port test module
calls ``jax.clear_caches()`` ad hoc. And on the port's terms, no port test
module builds or loads CUDA code, or touches the card, at import time:
module-level calls to ``_build.library`` / ``_build.build_all``, to
``torch.cuda.*`` (but the queries ``is_available`` / ``device_count``,
which a skip marker needs and which start no CUDA context), ``.cuda()``,
or tensors made with ``device="cuda..."``. Import-time card work breaks
the collection of the whole file on a CPU host.

Checks:
  * ``tests/conftest.py`` must define the fixture
    (``@pytest.fixture(autouse=True, scope="module")`` +
    ``jax.clear_caches()``);
  * no other port test module calls ``jax.clear_caches()``;
  * no port test module does card work at import time.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.base import Finding, register
from repro_torch.analysis.model import ModuleInfo, RepoModel, dotted_call_name

RULE_ID = "jit-cache-hygiene"
MAX_LEAKED_EXECUTABLES = 0
BUILD_ORIGIN = "repro_torch.kernels._build"
# torch.cuda queries that start no CUDA context (skip markers use them)
CUDA_QUERIES = {"is_available", "device_count"}


def _is_module_scoped_autouse(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        if not isinstance(dec, ast.Call):
            continue
        name = dotted_call_name(dec.func) or ""
        if name.rsplit(".", 1)[-1] != "fixture":
            continue
        autouse = False
        module_scoped = False
        for kw in dec.keywords:
            if kw.arg == "autouse" and isinstance(kw.value, ast.Constant):
                autouse = bool(kw.value.value)
            if kw.arg == "scope" and isinstance(kw.value, ast.Constant):
                module_scoped = kw.value.value == "module"
        if autouse and module_scoped:
            return True
    return False


def _calls_clear_caches(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted_call_name(node.func) or ""
            if name.rsplit(".", 1)[-1] == "clear_caches":
                return True
    return False


def _card_work(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    """What card work ``call`` does at import time, or None."""
    name = dotted_call_name(call.func) or ""
    parts = name.split(".")
    resolved = ".".join([mod.imports.get(parts[0], parts[0])] + parts[1:])
    if resolved in (f"{BUILD_ORIGIN}.library", f"{BUILD_ORIGIN}.build_all"):
        return f"`{name}` builds or loads CUDA code"
    if resolved.startswith("torch.cuda.") and parts[-1] not in CUDA_QUERIES:
        return f"`{name}` touches the card"
    if isinstance(call.func, ast.Attribute) and call.func.attr == "cuda":
        return "`.cuda()` copies to the card"
    for kw in call.keywords:
        if (kw.arg == "device" and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)
                and kw.value.value.startswith("cuda")):
            return f"`{name or '<call>'}(device={kw.value.value!r})` " \
                "makes a tensor on the card"
    return None


@register(RULE_ID, "conftest owns per-module jax.clear_caches(); no "
                   "import-time card work in the port's tests")
def check(model: RepoModel) -> List[Finding]:
    if not model.test_modules():
        return []
    findings: List[Finding] = []

    conftest = model.find("tests/conftest.py")
    has_fixture = False
    if conftest is not None:
        for qn, fi in conftest.functions.items():
            if _is_module_scoped_autouse(fi.node) and _calls_clear_caches(fi.node):
                has_fixture = True
                break
    if not has_fixture:
        findings.append(
            Finding(
                RULE_ID,
                conftest.rel if conftest else "tests/conftest.py",
                1,
                "tests/conftest.py must define a module-scoped autouse "
                "fixture calling jax.clear_caches() (per-module executable "
                f"cleanup; leak budget N={MAX_LEAKED_EXECUTABLES})",
            )
        )

    for mod in model.test_modules():
        is_conftest = mod.rel.endswith("conftest.py")
        # ad-hoc cache clearing outside conftest
        if not is_conftest:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    name = dotted_call_name(node.func) or ""
                    if name.rsplit(".", 1)[-1] == "clear_caches":
                        findings.append(
                            Finding(
                                RULE_ID,
                                mod.rel,
                                node.lineno,
                                "ad-hoc jax.clear_caches(): cleanup is owned "
                                "by the conftest module-scoped fixture",
                            )
                        )
        # import-time card work breaks collection on a CPU host
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    why = _card_work(mod, node)
                    if why:
                        findings.append(
                            Finding(
                                RULE_ID,
                                mod.rel,
                                node.lineno,
                                f"import-time card work in a test module: "
                                f"{why}; collecting the file fails on a CPU "
                                "host — do it inside the test",
                            )
                        )
    return findings
