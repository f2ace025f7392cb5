"""Parsed model of the port's files, shared by all analysis rules.

``RepoModel.load(root)`` parses the port's ``.py`` files once: every
module of ``src/repro_torch/``, the port's tests (``tests/test_torch_*.py``,
``tests/torch_parity.py``, ``tests/torch_sharded_worker.py`` and the shared
``tests/conftest.py``), and its tools (``chip_smoke.py``,
``examples/*_torch.py``), which are neither src nor test. Nothing under
``src/repro/`` and none of the reference's tests is read, so a suffix
lookup (``find("core/engine.py")``) always lands on the port's module.
It exposes cheap indexes the rules share: per-module function tables with
qualified names, import-alias maps, module-level integer/string
constants, and a global method-name index used for conservative call
resolution.

Nothing here imports the analyzed code; it is text + ``ast`` only, so the
analyzer runs in environments without torch installed.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: the port's files, as globs relative to the repo root
SCAN_GLOBS = (
    "src/repro_torch/**/*.py",
    "tests/test_torch_*.py",
    "tests/torch_parity.py",
    "tests/torch_sharded_worker.py",
    "tests/conftest.py",
    "chip_smoke.py",
    "examples/*_torch.py",
)


def dotted_call_name(node: ast.AST) -> Optional[str]:
    """'rng.fold_in' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    qualname: str  # "Cls.method" / "outer.inner" / "fn"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: Optional[str]  # enclosing class name, if a method


@dataclasses.dataclass
class ModuleInfo:
    path: Path
    rel: str  # repo-relative posix path
    tree: ast.Module
    lines: List[str]
    functions: Dict[str, FunctionInfo]
    imports: Dict[str, str]  # local alias -> dotted origin
    constants: Dict[str, object]  # module-level NAME = <int|float|str>

    @property
    def is_test(self) -> bool:
        return self.rel.startswith("tests/")

    @property
    def is_src(self) -> bool:
        return self.rel.startswith("src/")


def _collect_functions(tree: ast.Module) -> Dict[str, FunctionInfo]:
    out: Dict[str, FunctionInfo] = {}

    def visit(node: ast.AST, prefix: str, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                out[qn] = FunctionInfo(qn, child, cls)
                visit(child, f"{qn}.", cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", child.name)

    visit(tree, "", None)
    return out


def _collect_imports(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _collect_constants(tree: ast.Module) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and isinstance(node.value, ast.Constant):
                if isinstance(node.value.value, (int, float, str)):
                    out[tgt.id] = node.value.value
    return out


@dataclasses.dataclass
class RepoModel:
    root: Path
    modules: Dict[str, ModuleInfo]  # rel path -> info
    # method/function name -> [(rel, qualname)] across src modules
    name_index: Dict[str, List[Tuple[str, str]]]

    @classmethod
    def load(cls, root) -> "RepoModel":
        root = Path(root).resolve()
        modules: Dict[str, ModuleInfo] = {}
        paths = set()
        for pattern in SCAN_GLOBS:
            paths.update(p for p in root.glob(pattern) if p.is_file())
        for path in sorted(paths):
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(root).as_posix()
            try:
                text = path.read_text(encoding="utf-8")
                tree = ast.parse(text, filename=str(path))
            except (SyntaxError, UnicodeDecodeError) as e:
                raise SyntaxError(f"{rel}: cannot parse for analysis: {e}")
            modules[rel] = ModuleInfo(
                path=path,
                rel=rel,
                tree=tree,
                lines=text.splitlines(),
                functions=_collect_functions(tree),
                imports=_collect_imports(tree),
                constants=_collect_constants(tree),
            )
        name_index: Dict[str, List[Tuple[str, str]]] = {}
        for rel, mod in modules.items():
            if not mod.is_src:
                continue
            # Skip the analyzer itself: it is host-side tooling.
            if "/analysis/" in rel:
                continue
            for qn, fi in mod.functions.items():
                name = qn.rsplit(".", 1)[-1]
                name_index.setdefault(name, []).append((rel, qn))
        return cls(root=root, modules=modules, name_index=name_index)

    def src_modules(self) -> List[ModuleInfo]:
        return [
            m
            for rel, m in sorted(self.modules.items())
            if m.is_src and "/analysis/" not in rel
        ]

    def test_modules(self) -> List[ModuleInfo]:
        return [m for rel, m in sorted(self.modules.items()) if m.is_test]

    def find(self, rel_suffix: str) -> Optional[ModuleInfo]:
        """Module whose rel path ends with ``rel_suffix`` (posix)."""
        for rel, mod in self.modules.items():
            if rel == rel_suffix or rel.endswith("/" + rel_suffix):
                return mod
        return None

    def resolve_constant(self, mod: ModuleInfo, name: str):
        """Value of NAME in ``mod``, following one from-import hop."""
        if name in mod.constants:
            return mod.constants[name]
        origin = mod.imports.get(name)
        if origin and "." in origin:
            src_mod, attr = origin.rsplit(".", 1)
            target = self.find(src_mod.replace(".", "/") + ".py")
            if target and attr in target.constants:
                return target.constants[attr]
        return None
