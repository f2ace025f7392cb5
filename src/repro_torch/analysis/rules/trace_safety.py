"""trace-purity: no host sync, host branch or impurity on a step's tensors.

Contract (docs/INVARIANTS_TORCH.md §1): every function reachable from one
of the port's step roots — the counterparts of the reference's traced
roots — must keep the step's tensors on the device. In eager PyTorch a
``float()`` / ``int()`` / ``bool()`` of a card tensor, ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` / ``np.array``
of a tensor, ``torch.cuda.synchronize()``, and an ``if`` / ``while`` /
``assert`` on a tensor each wait for the card (and stand in the way of a
CUDA graph of the step); ``time`` / ``random`` / ``print`` / ``global``
make replay non-deterministic.

Roots are named in :data:`ROOTS` — ``PhaseEngine._step``,
``_step_unfused``, ``_step_gather``, ``_step_psum`` (the reference's scan
bodies), the inner ``grads_fn`` of ``make_plane_step``, the inner
``grads_fn`` and ``step_fn`` of ``make_worker_step``, and the step
functions ``launch/steps.py`` builds — plus the kernels' card paths
(``_card_*`` and ``*_launch`` in ``kernels/*.py``), whose tensors are
their positional parameters and the keyword-only ones in
:data:`CARD_TENSOR_KWARGS` (the rest is launch configuration).

Implementation: the reference's AST-level taint analysis. Taint starts at
the roots' tensor parameters and propagates interprocedurally through a
conservative intra-port call graph (module-level defs, ``self.`` methods,
imported names, plus unique-method-name resolution). It does not pass
through ``.shape`` / ``.dtype`` / ``.ndim`` / ``.device`` and the other
host metadata in :data:`UNTAINT_ATTRS` / :data:`UNTAINT_CALLS`,
``len()``, ``is None`` or string compares, nor through the host fields of
the port's state carriers (:data:`HOST_ATTRS`). A host read is flagged
where it happens and its result is a host value: what follows it on the
host is not flagged again.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import Finding, register
from repro_torch.analysis.model import (
    FunctionInfo,
    ModuleInfo,
    RepoModel,
    dotted_call_name,
)

RULE_ID = "trace-purity"

#: (module rel-path suffix, qualname, host parameters): the port's
#: counterparts of the reference's traced roots. The host parameters are
#: callables and step counters; every other parameter is a tensor (tree).
ROOTS = (
    ("core/engine.py", "PhaseEngine._step", ("grads_fn",)),
    ("core/engine.py", "PhaseEngine._step_unfused", ("wstep",)),
    ("core/engine.py", "PhaseEngine._step_gather", ("grads_fn",)),
    ("core/engine.py", "PhaseEngine._step_psum", ("grads_fn",)),
    ("core/engine.py", "make_plane_step.grads_fn", ()),
    ("core/engine.py", "make_worker_step.grads_fn", ()),
    ("core/engine.py", "make_worker_step.step_fn", ("step",)),
    ("launch/steps.py", "make_train_step.train_step", ("step",)),
    ("launch/steps.py", "make_phase_step.phase_step", ("step0",)),
    ("launch/steps.py", "make_prefill_step.prefill_step", ()),
    ("launch/steps.py", "make_decode_step.decode_step", ()),
)
#: keyword-only parameters of a card path that carry tensors
CARD_TENSOR_KWARGS = {"codes", "W", "u", "resid"}

#: tensor attributes that are host metadata
UNTAINT_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "is_meta", "layout",
    "requires_grad", "itemsize", "nbytes",
}
#: fields of the port's state carriers (``EngineState``, ``SchedState``,
#: ``FaultState``, the decode cache) that hold host values, as attributes
#: or string keys: the step count, the plane layout, the schedule's host
#: carry, the fault rows (numpy), the threefry keys (CPU int64 tensors,
#: ``rng.PRNGKey``) and the decode position (a Python int)
HOST_ATTRS = {"step", "spec", "sched", "fault", "key", "dec_key", "pos"}
#: (module suffix, qualname) of calls whose result is a host value: the
#: plane layouts, built from the leaves' shapes and dtypes
HOST_FACTORIES = {("core/flat.py", "FlatSpec.of"),
                  ("core/flat.py", "FlatOptSpec.of")}
#: the loader of the kernels' libraries: its body (the build on first use)
#: is not followed, and a call on a library it returned gives the launch's
#: ``cudaError_t``, a host int
LIBRARY_LOADER = "repro_torch.kernels._build.library"
#: calls whose result is host metadata
UNTAINT_CALLS = {
    "len", "isinstance", "type", "hasattr", "callable", "repr",
    "numel", "dim", "size", "stride", "data_ptr", "is_contiguous",
    "element_size", "storage_offset", "get_device", "is_floating_point",
}
IMPURE_CALLS = {"print", "input", "open", "breakpoint", "exec", "eval"}
IMPURE_MODULES = {"time", "random", "os", "sys", "io", "logging"}
COERCE_CALLS = {"float", "int", "bool"}
#: tensor methods that copy to the host (and wait for the card)
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# Method names never resolved via the unique-name fallback (too generic).
NO_FALLBACK = {
    "get", "update", "items", "keys", "values", "append", "extend", "pop",
    "copy", "sum", "mean", "max", "min", "reshape", "astype", "at", "set",
    "add", "dot", "tolist", "item", "split", "join", "format", "apply",
    "init", "build", "read", "write", "close", "encode", "decode",
    "to", "view", "detach", "clone", "contiguous", "float", "double",
    "half", "cpu", "cuda", "numpy", "zero_", "copy_", "add_", "mul_",
    "forward", "backward", "step", "run", "load", "save",
}

QualKey = Tuple[str, str]  # (module rel path, function qualname)


def _params(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if a.vararg:
        names.append(a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _pos_params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _module_dotted(mod: ModuleInfo) -> str:
    return mod.rel[len("src/"):-len(".py")].replace("/", ".")


def _resolved(mod: ModuleInfo, name: str) -> str:
    """``name``'s dotted origin through ``mod``'s imports; a module-level
    def of ``mod`` resolves to ``mod``'s own dotted path."""
    parts = name.split(".")
    head = mod.imports.get(parts[0])
    if head is None and parts[0] in mod.functions and mod.is_src:
        head = f"{_module_dotted(mod)}.{parts[0]}"
    return ".".join([head or parts[0]] + parts[1:])


def _matches(key, table) -> bool:
    rel, qn = key
    return any(qn == q and rel.endswith("/" + suffix) for suffix, q in table)


class _Resolver:
    """Conservative intra-port call resolution."""

    def __init__(self, model: RepoModel):
        self.model = model
        # dotted module path ("repro_torch.core.flat") -> ModuleInfo
        self.by_dotted: Dict[str, ModuleInfo] = {}
        for mod in model.src_modules():
            dotted = _module_dotted(mod)
            self.by_dotted[dotted] = mod
            if dotted.endswith(".__init__"):
                self.by_dotted[dotted[: -len(".__init__")]] = mod

    def resolve_local(self, mod, caller_qn, name) -> Optional[QualKey]:
        parts = caller_qn.split(".") if caller_qn else []
        for i in range(len(parts), -1, -1):
            cand = ".".join(parts[:i] + [name]) if i else name
            if cand in mod.functions:
                return (mod.rel, cand)
        return None

    def resolve_dotted(self, origin: str) -> Optional[QualKey]:
        """'repro_torch.core.flat.FlatSpec.pack' / 'repro_torch.rng.split'."""
        if not origin.startswith("repro_torch."):
            return None
        parts = origin.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = self.by_dotted.get(".".join(parts[:cut]))
            if mod is None:
                continue
            qn = ".".join(parts[cut:])
            if qn in mod.functions:
                return (mod.rel, qn)
            return None
        return None

    def resolve_call(self, mod, caller: FunctionInfo, func) -> Optional[QualKey]:
        if isinstance(func, ast.Name):
            hit = self.resolve_local(mod, caller.qualname, func.id)
            if hit:
                return hit
            origin = mod.imports.get(func.id)
            if origin:
                return self.resolve_dotted(origin)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        base = func.value
        if isinstance(base, ast.Name):
            if base.id in ("self", "cls") and caller.cls:
                qn = f"{caller.cls}.{attr}"
                if qn in mod.functions:
                    return (mod.rel, qn)
            origin = mod.imports.get(base.id)
            if origin:
                hit = self.resolve_dotted(f"{origin}.{attr}")
                if hit:
                    return hit
        # Unique-method fallback: e.g. ``sched.decision_state(...)`` when
        # ``decision_state`` is defined exactly once across src/.
        if attr not in NO_FALLBACK:
            cands = self.model.name_index.get(attr, [])
            if len(cands) == 1:
                rel, qn = cands[0]
                return (rel, qn)
        return None


def _is_card_path(mod: ModuleInfo, qn: str) -> bool:
    if "/kernels/" not in mod.rel or "." in qn:
        return False
    return qn.startswith("_card_") or qn.endswith("_launch")


def _discover_roots(model: RepoModel) -> Dict[QualKey, Set[str]]:
    """qualkey -> set of host (untainted) param names."""
    roots: Dict[QualKey, Set[str]] = {}
    for suffix, qn, host in ROOTS:
        mod = model.find(suffix)
        if mod is not None and mod.is_src and qn in mod.functions:
            roots[(mod.rel, qn)] = set(host)
    for mod in model.src_modules():
        for qn, fi in mod.functions.items():
            if _is_card_path(mod, qn):
                a = fi.node.args
                host = {p.arg for p in a.kwonlyargs
                        if p.arg not in CARD_TENSOR_KWARGS}
                if a.kwarg:
                    host.add(a.kwarg.arg)
                roots[(mod.rel, qn)] = host
    return roots


class _FnAnalysis:
    """One walk of a function body given a tainted-param set."""

    def __init__(self, model, resolver, mod, fi, tainted_params,
                 returns_tainted: Dict[QualKey, bool],
                 returns_elems: Dict[QualKey, Optional[Tuple[bool, ...]]]):
        self.model = model
        self.resolver = resolver
        self.mod = mod
        self.fi = fi
        self.env: Set[str] = set(tainted_params)
        self.containers: Set[str] = set()
        self.returns_tainted_map = returns_tainted
        self.returns_elems_map = returns_elems
        self.libs: Set[str] = set()  # names bound to a loaded library
        self.callee_taints: Dict[QualKey, Set[str]] = {}
        self.callees: Set[QualKey] = set()
        self.returns_tainted = False
        # per-element return taint when every return is a tuple of one
        # length; None once a return is anything else
        self.return_elems: Optional[List[bool]] = None
        self.return_mixed = False
        self.findings: List[Tuple[int, str]] = []

    @property
    def elems(self) -> Optional[Tuple[bool, ...]]:
        if self.return_mixed or self.return_elems is None:
            return None
        return tuple(self.return_elems)

    # -- taint evaluation ------------------------------------------------
    def tainted(self, node) -> bool:
        if node is None or isinstance(node, (ast.Constant, ast.Lambda)):
            return False
        if isinstance(node, ast.Name):
            # Host containers of tensors (tree_flatten leaves): the
            # container itself is static (`not leaves`, `len(leaves)`),
            # its elements are tensors (see Subscript below).
            if node.id in self.containers:
                return False
            return node.id in self.env
        if isinstance(node, ast.Attribute):
            if node.attr in UNTAINT_ATTRS or node.attr in HOST_ATTRS:
                return False
            return self.tainted(node.value)
        if isinstance(node, ast.Compare):
            ops_static = any(isinstance(o, (ast.Is, ast.IsNot)) for o in node.ops)
            vals = [node.left] + list(node.comparators)
            if ops_static:
                return False
            if any(isinstance(v, ast.Constant) and isinstance(v.value, str) for v in vals):
                return False
            # `x != ()` / `x == []`: structural tree checks, host-side.
            if any(
                isinstance(v, (ast.Tuple, ast.List)) and not v.elts for v in vals
            ):
                return False
            return any(self.tainted(v) for v in vals)
        if isinstance(node, ast.Call):
            return self.call_taint(node)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.IfExp):
            return (self.tainted(node.body) or self.tainted(node.orelse)
                    or self.tainted(node.test))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.tainted(v) for v in list(node.keys) + list(node.values) if v)
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Constant) and sl.value in HOST_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id in self.containers:
                return True  # element of a host container of tensors
            return self.tainted(node.value)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            added = []
            for gen in node.generators:
                for nm, t in self.iter_taints(gen.target, gen.iter).items():
                    if t and nm not in self.env:
                        self.env.add(nm)
                        added.append(nm)
            if isinstance(node, ast.DictComp):
                out = self.tainted(node.key) or self.tainted(node.value)
            else:
                out = self.tainted(node.elt)
            for nm in added:
                self.env.discard(nm)
            return out
        if isinstance(node, ast.JoinedStr):
            return False
        # Conservative default: any tainted Name inside.
        return any(
            isinstance(n, ast.Name) and n.id in self.env for n in ast.walk(node)
        )

    def _host_read(self, node: ast.Call) -> bool:
        """A call whose result is a host value read from its input."""
        name = dotted_call_name(node.func) or ""
        parts = name.split(".")
        if parts[-1] in COERCE_CALLS and len(parts) == 1:
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in HOST_METHODS:
            return True
        root = self.mod.imports.get(parts[0], parts[0]).split(".")[0]
        return root == "numpy" and len(parts) > 1

    def call_taint(self, node: ast.Call) -> bool:
        name = dotted_call_name(node.func) or ""
        tail = name.rsplit(".", 1)[-1]
        self.record_call(node)
        if tail in UNTAINT_CALLS or self._host_read(node):
            return False
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in self.libs):
            return False  # a launch's cudaError_t
        key = self.resolver.resolve_call(self.mod, self.fi, node.func)
        if key is not None and _matches(key, HOST_FACTORIES):
            return False
        args_tainted = any(self.tainted(a) for a in node.args) or any(
            self.tainted(k.value) for k in node.keywords
        )
        recv_tainted = isinstance(node.func, ast.Attribute) and self.tainted(
            node.func.value
        )
        if key is not None:
            # Optimistic until the callee is analyzed: the fixpoint loop
            # re-enqueues callers whenever a callee's return taint flips
            # to True, so starting at False converges without baking an
            # early over-approximation into the monotone taint sets.
            return self.returns_tainted_map.get(key, False)
        return args_tainted or recv_tainted

    # -- call graph ------------------------------------------------------
    def record_call(self, node: ast.Call) -> None:
        if self._is_loader(node):
            return
        key = self.resolver.resolve_call(self.mod, self.fi, node.func)
        if key is None:
            return
        self.callees.add(key)
        rel, qn = key
        callee = self.model.modules[rel].functions[qn]
        pos = _pos_params(callee.node)
        offset = 0
        if callee.cls and isinstance(node.func, ast.Attribute):
            if pos and pos[0] in ("self", "cls"):
                offset = 1
        sink = self.callee_taints.setdefault(key, set())
        for i, arg in enumerate(node.args):
            if isinstance(arg, ast.Starred):
                continue
            if self.tainted(arg):
                j = i + offset
                if j < len(pos):
                    sink.add(pos[j])
                elif callee.node.args.vararg:
                    sink.add(callee.node.args.vararg.arg)
        for kw in node.keywords:
            if kw.arg and self.tainted(kw.value):
                sink.add(kw.arg)

    def _is_loader(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call) and _resolved(
            self.mod, dotted_call_name(node.func) or "") == LIBRARY_LOADER)

    def iter_taints(self, target, it) -> Dict[str, bool]:
        """name -> taint for the target of ``for target in it``:
        ``zip(a, b)`` and ``enumerate(a)`` unpack element by element."""
        names = self._target_names(target)
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and isinstance(target, (ast.Tuple, ast.List))
                and not any(isinstance(e, ast.Starred) for e in target.elts)
                and not any(isinstance(a, ast.Starred) for a in it.args)
                and not it.keywords):
            if it.func.id == "zip" and len(it.args) == len(target.elts):
                out: Dict[str, bool] = {}
                for e, a in zip(target.elts, it.args):
                    t = self.tainted(a)
                    for nm in self._target_names(e):
                        out[nm] = t
                return out
            if it.func.id == "enumerate" and len(target.elts) == 2 \
                    and len(it.args) == 1:
                out = {nm: False for nm in self._target_names(target.elts[0])}
                t = self.tainted(it.args[0])
                for nm in self._target_names(target.elts[1]):
                    out[nm] = t
                return out
        t = self.tainted(it)
        return {nm: t for nm in names}

    # -- impurity / host-read checks -------------------------------------
    def flag(self, node, msg: str) -> None:
        self.findings.append((getattr(node, "lineno", 0), msg))

    def check_call(self, node: ast.Call) -> None:
        name = dotted_call_name(node.func) or ""
        parts = name.split(".")
        tail = parts[-1]
        root_origin = self.mod.imports.get(parts[0], parts[0])
        src = ast.unparse(node)
        if len(src) > 60:
            src = src[:57] + "..."
        if tail in IMPURE_CALLS and len(parts) == 1:
            self.flag(node, f"impure call in traced code: `{src}`")
            return
        if root_origin.split(".")[0] in IMPURE_MODULES and len(parts) > 1:
            self.flag(node, f"host-side `{root_origin.split('.')[0]}` call in traced code: `{src}`")
            return
        if _resolved(self.mod, name) == "torch.cuda.synchronize":
            self.flag(node, "`torch.cuda.synchronize()` waits for the card in "
                      f"traced code: `{src}`")
            return
        if tail in COERCE_CALLS and len(parts) == 1:
            if any(self.tainted(a) for a in node.args):
                self.flag(node, f"`{tail}()` coerces a traced value: `{src}`")
            return
        if isinstance(node.func, ast.Attribute) and node.func.attr in HOST_METHODS:
            if self.tainted(node.func.value):
                self.flag(node, f"`.{node.func.attr}()` copies a traced value to the host: `{src}`")
            return
        if root_origin.split(".")[0] == "numpy" and len(parts) > 1:
            if any(self.tainted(a) for a in node.args):
                self.flag(node, f"`np.*` coercion of a traced value: `{src}`")

    # -- statement walk --------------------------------------------------
    @staticmethod
    def _target_names(t) -> List[str]:
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, (ast.Tuple, ast.List)):
            out = []
            for e in t.elts:
                out.extend(_FnAnalysis._target_names(e))
            return out
        if isinstance(t, ast.Starred):
            return _FnAnalysis._target_names(t.value)
        return []

    def assign(self, targets, value_tainted: bool) -> None:
        for t in targets:
            names = self._target_names(t)
            if value_tainted:
                self.env.update(names)
            else:
                for nm in names:
                    self.env.discard(nm)

    def _unpack_call(self, s: ast.Assign) -> bool:
        """``a, b = f(...)`` with ``f`` returning tuples of that length:
        each name takes its element's taint. Returns True when handled."""
        if len(s.targets) != 1 or not isinstance(s.value, ast.Call):
            return False
        tgt = s.targets[0]
        if not isinstance(tgt, (ast.Tuple, ast.List)) or any(
                isinstance(e, ast.Starred) for e in tgt.elts):
            return False
        key = self.resolver.resolve_call(self.mod, self.fi, s.value.func)
        if key is None or _matches(key, HOST_FACTORIES):
            return False
        elems = self.returns_elems_map.get(key)
        if elems is None or len(elems) != len(tgt.elts):
            return False
        self.tainted(s.value)  # records the call's argument taints
        for e, t in zip(tgt.elts, elems):
            self.assign([e], t)
        return True

    def _tree_destructure(self, s: ast.Assign) -> bool:
        """Handle ``leaves = tree_leaves(x)`` (host container of tensors)
        and ``leaves, treedef = tree_flatten(x)`` (the treedef is pure
        host metadata), for the port's and torch's tree utilities.
        Returns True when handled."""
        if not isinstance(s.value, ast.Call) or len(s.targets) != 1:
            return False
        resolved = _resolved(self.mod, dotted_call_name(s.value.func) or "")
        if not resolved.startswith(("repro_torch.", "torch.")):
            return False
        tail = resolved.rsplit(".", 1)[-1]
        tgt = s.targets[0]
        if tail in ("leaves", "tree_leaves") and isinstance(tgt, ast.Name):
            self.containers.add(tgt.id)
            self.env.discard(tgt.id)
            return True
        if tail in ("flatten", "tree_flatten") and isinstance(
            tgt, (ast.Tuple, ast.List)
        ) and len(tgt.elts) == 2:
            first, second = tgt.elts
            if isinstance(first, ast.Name):
                self.containers.add(first.id)
                self.env.discard(first.id)
            if isinstance(second, ast.Name):
                self.env.discard(second.id)
            return True
        return False

    def eval_calls(self, expr) -> None:
        """Record+check every call in an arbitrary expression."""
        if expr is None:
            return
        for node in _iter_own_expr(expr):
            if isinstance(node, ast.Call):
                self.record_call(node)
                self.check_call(node)

    def walk(self, body) -> None:
        for stmt in body:
            self.stmt(stmt)

    def stmt(self, s) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(s, ast.Global):
            self.flag(s, "`global` mutation in traced code")
            return
        if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = s.value
            self.eval_calls(value)
            if isinstance(s, ast.Assign) and self._tree_destructure(s):
                return
            if isinstance(s, ast.Assign) and self._is_loader(value):
                for t in s.targets:
                    self.libs.update(self._target_names(t))
                self.assign(s.targets, False)
                return
            if isinstance(s, ast.Assign) and self._unpack_call(s):
                return
            if isinstance(s, ast.Assign):
                self.assign(s.targets, self.tainted(value))
            elif isinstance(s, ast.AnnAssign):
                if value is not None:
                    self.assign([s.target], self.tainted(value))
            else:  # AugAssign: x += v
                t = self.tainted(value) or self.tainted(s.target)
                self.assign([s.target], t)
            return
        if isinstance(s, (ast.If, ast.While)):
            self.eval_calls(s.test)
            if self.tainted(s.test):
                kw = "if" if isinstance(s, ast.If) else "while"
                src = ast.unparse(s.test)
                if len(src) > 60:
                    src = src[:57] + "..."
                self.flag(s, f"Python `{kw}` on a traced value: `{src}`")
            self.walk(s.body)
            self.walk(s.orelse)
            return
        if isinstance(s, ast.Assert):
            self.eval_calls(s.test)
            if self.tainted(s.test):
                src = ast.unparse(s.test)
                if len(src) > 60:
                    src = src[:57] + "..."
                self.flag(s, f"`assert` on a traced value: `{src}`")
            return
        if isinstance(s, ast.For):
            self.eval_calls(s.iter)
            if isinstance(s.iter, ast.Name) and s.iter.id in self.containers:
                self.assign([s.target], True)
            else:
                for nm, t in self.iter_taints(s.target, s.iter).items():
                    self.assign([ast.Name(id=nm)], t)
            self.walk(s.body)
            self.walk(s.orelse)
            return
        if isinstance(s, ast.With):
            for item in s.items:
                self.eval_calls(item.context_expr)
                if item.optional_vars is not None:
                    self.assign([item.optional_vars], self.tainted(item.context_expr))
            self.walk(s.body)
            return
        if isinstance(s, ast.Try):
            self.walk(s.body)
            for h in s.handlers:
                self.walk(h.body)
            self.walk(s.orelse)
            self.walk(s.finalbody)
            return
        if isinstance(s, ast.Return):
            self.eval_calls(s.value)
            if s.value is not None and self.tainted(s.value):
                self.returns_tainted = True
            v = s.value
            if isinstance(v, ast.Tuple) and not any(
                    isinstance(e, ast.Starred) for e in v.elts):
                elems = [self.tainted(e) for e in v.elts]
                if self.return_elems is None:
                    self.return_elems = elems
                elif len(self.return_elems) == len(elems):
                    self.return_elems = [a or b for a, b in
                                         zip(self.return_elems, elems)]
                else:
                    self.return_mixed = True
            else:
                self.return_mixed = True
            return
        if isinstance(s, ast.Expr):
            self.eval_calls(s.value)
            return
        if isinstance(s, ast.Raise):
            return
        # Delete, Pass, Break, Continue, Import, Nonlocal: nothing to do.

    def run(self) -> None:
        # Two passes so loop-carried taint propagates.
        body = self.fi.node.body if not isinstance(self.fi.node, ast.Module) else []
        self.walk(body)
        self.findings.clear()
        self.walk(body)


def _iter_own_expr(expr):
    stack = [expr]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, ast.Lambda):
            continue
        stack.extend(ast.iter_child_nodes(n))


@register(RULE_ID, "no host sync, host branch or impurity on a step's tensors")
def check(model: RepoModel) -> List[Finding]:
    resolver = _Resolver(model)
    roots = _discover_roots(model)

    taints: Dict[QualKey, Set[str]] = {}
    returns_tainted: Dict[QualKey, bool] = {}
    returns_elems: Dict[QualKey, Optional[Tuple[bool, ...]]] = {}
    for key, host in roots.items():
        mod = model.modules[key[0]]
        fn = mod.functions[key[1]].node
        tainted = {
            p for p in _params(fn) if p not in host and p not in ("self", "cls")
        }
        taints[key] = tainted

    worklist = list(taints)
    analyses: Dict[QualKey, _FnAnalysis] = {}
    steps = 0
    while worklist and steps < 10000:
        steps += 1
        key = worklist.pop()
        rel, qn = key
        mod = model.modules[rel]
        fi = mod.functions[qn]
        an = _FnAnalysis(model, resolver, mod, fi, taints.get(key, set()),
                         returns_tainted, returns_elems)
        an.run()
        analyses[key] = an
        if (returns_tainted.get(key) != an.returns_tainted
                or returns_elems.get(key) != an.elems):
            returns_tainted[key] = an.returns_tainted
            returns_elems[key] = an.elems
            # Re-analyze callers that saw a different return taint.
            for ck, ca in analyses.items():
                if key in ca.callees and ck not in worklist:
                    worklist.append(ck)
        for callee, names in an.callee_taints.items():
            crel = callee[0]
            if "/analysis/" in crel:
                continue
            have = taints.setdefault(callee, set())
            if (names - have) or callee not in analyses:
                have.update(names)
                if callee not in worklist:
                    worklist.append(callee)

    findings: List[Finding] = []
    seen = set()
    for key, an in analyses.items():
        rel, qn = key
        for line, msg in an.findings:
            full = f"{qn}: {msg}"
            sig = (rel, line, full)
            if sig in seen:
                continue
            seen.add(sig)
            findings.append(Finding(RULE_ID, rel, line, full))
    return findings
