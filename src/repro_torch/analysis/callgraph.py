"""AST project index, call-graph reachability, and tensor taint for the
port (the counterpart of the reference's ``analysis/callgraph.py``).

Everything downstream (host-sync, recapture-hazard) runs off ONE pass
over ``src/repro_torch`` — the analyzed code is never imported, so the
analyzer inspects trees that would not even import (test fixtures,
broken branches).  Only the port is indexed, under module names starting
``repro_torch.``; functions nested in functions are indexed too (as
``outer.inner``), so a closure can be a root, and each is reachable from
the function it is defined in.

Resolution is deliberately an OVER-approximation: an attribute call
``x.step()`` resolves to EVERY project function named ``step`` (with a
same-class fast path for ``self.method()``).  For a hot-path linter the
cost of over-reach is a too-wide hot set, which the baseline absorbs;
the cost of under-reach would be silent misses.

Tensor taint answers "may this expression hold a tensor?" (a CPU tensor
is a tensor too, so the taint over-reaches the device):

  sources   calls into ``torch.*`` (minus host-side calls: ``torch.device``,
            ``torch.Generator``, ``torch.cuda.*``, ...), calls to project
            functions that return tensors (a fixpoint seeded with every
            function annotated ``-> Tensor``), parameters annotated
            ``Tensor`` / ``torch.Tensor`` (``Optional[Tensor]`` too),
            calls of ``nn.Module`` instances, attributes assigned tensors
            ANYWHERE in the project (attribute taint is name-global), and
            method calls on a tensor.
  not       host metadata (``.shape``, ``.size()``, ``.numel()``,
            ``.dim()``, ``.dtype``, ``.device``, ``.data_ptr()``,
            ``.stride()``, ``.is_contiguous()``), ``numpy.*`` results, and
            the results of the pulls themselves (``.cpu()``, ``.numpy()``,
            ``.item()``, ``.tolist()``, ``.to("cpu")``): those are the
            sinks, flagged by the host-sync checker; what they return
            lives on the host.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

PACKAGE = "repro_torch"

# attribute reads that return host metadata, never a tensor
HOST_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                   "requires_grad", "nbytes", "itemsize", "names"}
# tensor methods whose result is host metadata
HOST_META_METHODS = {"size", "numel", "dim", "data_ptr", "stride",
                     "is_contiguous", "element_size", "get_device",
                     "is_floating_point", "is_complex", "storage_offset",
                     "untyped_storage", "nelement", "ndimension"}
# tensor methods whose RESULT is on the host: the pulls (sinks, flagged
# by the host-sync checker)
HOST_RESULT_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch-namespace calls that return host values
HOST_SAFE_CALLS = {
    "torch.device", "torch.Generator", "torch.is_tensor", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.set_grad_enabled",
    "torch.is_grad_enabled", "torch.finfo", "torch.iinfo",
    "torch.get_default_dtype", "torch.set_default_dtype", "torch.Size",
    "torch.manual_seed", "torch.compile", "torch.numel",
    "torch.is_floating_point", "torch.use_deterministic_algorithms",
    "torch.autograd._profiler_enabled",
}
HOST_SAFE_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.profiler.",
                      "torch.distributed.", "torch.utils.", "torch.testing.",
                      "torch.library.", "torch.compiler.", "torch._dynamo.",
                      "torch.version.")
DEVICE_ANNOTATIONS = {"Tensor", "torch.Tensor"}
MODULE_BASES = {"nn.Module", "torch.nn.Module", "Module"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """Flatten ``a.b.c`` attribute chains rooted at a Name; else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def annotation_is_tensor(node: Optional[ast.AST]) -> bool:
    """``Tensor``, ``torch.Tensor`` or a subscript holding one
    (``Optional[Tensor]``, ``Tuple[Tensor, ...]``)."""
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return "Tensor" in node.value
    return any(dotted_name(n) in DEVICE_ANNOTATIONS
               for n in ast.walk(node)
               if isinstance(n, (ast.Name, ast.Attribute)))


@dataclass
class FunctionInfo:
    qualname: str                    # pkg.mod.Class.fn | pkg.mod.fn[.inner]
    name: str
    module: str                      # pkg.mod
    cls: Optional[str]               # bare class name, if a method
    node: ast.AST                    # FunctionDef / AsyncFunctionDef
    path: Path
    parent: Optional[str] = None     # enclosing function, for a nested def
    returns_tensor: bool = False     # annotated ``-> Tensor``
    calls: Set[str] = field(default_factory=set)   # resolved qualnames

    @property
    def method_key(self) -> str:
        """``Class.name`` (or the bare name of a function)."""
        return f"{self.cls}.{self.name}" if self.cls else self.name


@dataclass
class ModuleInfo:
    name: str
    path: Path
    tree: ast.Module
    source: str
    imports: Dict[str, str] = field(default_factory=dict)  # alias -> dotted


class Project:
    """Parsed index of every module of one package under ``src_dir``."""

    def __init__(self, src_dir: Path, rel_to: Optional[Path] = None,
                 package: str = PACKAGE):
        self.src_dir = Path(src_dir)
        self.package = package
        self.rel_to = Path(rel_to) if rel_to else self.src_dir.parent
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_name: Dict[str, List[str]] = {}
        self.classes: Dict[str, str] = {}       # bare class name -> qualname
        self.class_methods: Dict[str, Set[str]] = {}  # cls qual -> bare names
        self.module_classes: Set[str] = set()   # bare names of nn.Modules
        self.overrides: Dict[str, Set[str]] = {}  # cls qual -> subclass quals
        self.nested: Dict[str, Dict[str, str]] = {}   # outer -> {name: qual}
        self.device_attrs: Set[str] = set()
        self.module_attrs: Set[str] = set()     # attributes holding modules
        self.returns_device: Set[str] = set()
        self._parse()
        self._index()
        self._resolve_calls()
        self._device_fixpoint()

    # ------------------------------------------------------------------
    def _parse(self) -> None:
        root = self.src_dir / self.package
        for p in sorted(root.rglob("*.py")):
            rel = p.relative_to(self.src_dir)
            parts = list(rel.parts[:-1])
            stem = rel.parts[-1][:-3]
            if stem != "__init__":
                parts.append(stem)
            mod = ".".join(parts)
            try:
                src = p.read_text()
                tree = ast.parse(src)
            except (SyntaxError, UnicodeDecodeError):
                continue
            info = ModuleInfo(mod, p, tree, src)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        info.imports[a.asname or a.name.split(".")[0]] = \
                            a.name if a.asname else a.name.split(".")[0]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    for a in node.names:
                        info.imports[a.asname or a.name] = \
                            f"{node.module}.{a.name}"
            self.modules[mod] = info

    def _index(self) -> None:
        for mod, info in self.modules.items():
            for node in info.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._add_function(info, node, cls=None)
                elif isinstance(node, ast.ClassDef):
                    cq = f"{mod}.{node.name}"
                    self.classes.setdefault(node.name, cq)
                    for b in node.bases:
                        base = (dotted_name(b) or "").split(".")[-1]
                        self.overrides.setdefault(base, set()).add(cq)
                    if any(dotted_name(b) in MODULE_BASES
                           for b in node.bases):
                        self.module_classes.add(node.name)
                    names = self.class_methods.setdefault(cq, set())
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            self._add_function(info, sub, cls=node.name)
                            names.add(sub.name)

    def _add_function(self, info: ModuleInfo, node, cls: Optional[str],
                      parent: Optional[str] = None) -> None:
        if parent is not None:
            qual = f"{parent}.{node.name}"
        elif cls:
            qual = f"{info.name}.{cls}.{node.name}"
        else:
            qual = f"{info.name}.{node.name}"
        fi = FunctionInfo(qual, node.name, info.name,
                          cls if parent is None else None, node, info.path,
                          parent=parent,
                          returns_tensor=annotation_is_tensor(node.returns))
        self.functions[qual] = fi
        self.by_name.setdefault(node.name, []).append(qual)
        for sub in _walk_own(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.nested.setdefault(qual, {})[sub.name] = \
                    f"{qual}.{sub.name}"
                self._add_function(info, sub, cls=None, parent=qual)

    # ------------------------------------------------------------------
    def resolve_call(self, fi: FunctionInfo, call: ast.Call) -> Set[str]:
        """Project qualnames a call MAY dispatch to (over-approximate)."""
        out: Set[str] = set()
        func = call.func
        info = self.modules[fi.module]
        if isinstance(func, ast.Name):
            scope: Optional[str] = fi.qualname
            while scope is not None:         # closures: enclosing defs
                q = self.nested.get(scope, {}).get(func.id)
                if q:
                    out.add(q)
                    return out
                scope = self.functions[scope].parent
            target = info.imports.get(func.id, f"{fi.module}.{func.id}")
            if target in self.functions:
                out.add(target)
            # class instantiation -> its init hooks
            cq = (target if target in self.class_methods
                  else self.classes.get(func.id))
            if cq:
                for init in ("__init__", "__post_init__"):
                    q = f"{cq}.{init}"
                    if q in self.functions:
                        out.add(q)
        elif isinstance(func, ast.Attribute):
            d = dotted_name(func)
            if d:
                root, _, rest = d.partition(".")
                full = f"{info.imports.get(root, root)}.{rest}" if rest else d
                if full in self.functions:
                    out.add(full)
            if not out:
                # self.method(): the class's own method and its
                # subclasses' overrides first
                if (isinstance(func.value, ast.Name)
                        and func.value.id == "self" and fi.cls):
                    cq = f"{fi.module}.{fi.cls}"
                    if func.attr in self.class_methods.get(cq, set()):
                        out.update(f"{c}.{func.attr}"
                                   for c in self._subclasses(cq)
                                   if func.attr
                                   in self.class_methods.get(c, ()))
                        return out
                out.update(self.by_name.get(func.attr, ()))
        return out

    def _subclasses(self, cq: str) -> Set[str]:
        """``cq`` and every project class deriving from it (by bare
        name)."""
        seen, frontier = set(), [cq]
        while frontier:
            c = frontier.pop()
            if c not in seen:
                seen.add(c)
                frontier.extend(self.overrides.get(c.split(".")[-1], ()))
        return seen

    def _resolve_calls(self) -> None:
        for fi in self.functions.values():
            for node in _walk_own(fi.node):
                if isinstance(node, ast.Call):
                    fi.calls |= self.resolve_call(fi, node)
            # a nested def runs (or is handed out) from its enclosing def
            fi.calls |= set(self.nested.get(fi.qualname, {}).values())

    def reachable(self, roots: Iterable[str]) -> Set[str]:
        seen: Set[str] = set()
        frontier = [r for r in roots if r in self.functions]
        while frontier:
            q = frontier.pop()
            if q in seen:
                continue
            seen.add(q)
            frontier.extend(self.functions[q].calls - seen)
        return seen

    # ------------------------------------------------------------------
    # tensor taint
    # ------------------------------------------------------------------
    def _device_fixpoint(self) -> None:
        """Iterate attribute taint and returns-tensor to a fixed point
        (attribute assignments and returns feed each other)."""
        self.returns_device = {q for q, f in self.functions.items()
                               if f.returns_tensor}
        self.module_attrs = self._collect_module_attrs()
        for _ in range(6):
            attrs = self._collect_device_attrs()
            rets = set(self.returns_device)
            for q, fi in self.functions.items():
                if q in rets:
                    continue
                taint = DeviceTaint(self, fi)
                env = taint.build_env()
                for node in _walk_own(fi.node):
                    if isinstance(node, ast.Return) and node.value is not None:
                        if taint.is_device(node.value, env):
                            rets.add(q)
                            break
            if attrs == self.device_attrs and rets == self.returns_device:
                break
            self.device_attrs = attrs
            self.returns_device = rets

    def _collect_module_attrs(self) -> Set[str]:
        attrs: Set[str] = set()
        for fi in self.functions.values():
            for node in _walk_own(fi.node):
                if (isinstance(node, ast.Assign)
                        and self.is_module_ctor(fi, node.value)):
                    attrs.update(t.attr for t in node.targets
                                 if isinstance(t, ast.Attribute))
        return attrs

    def is_module_ctor(self, fi: FunctionInfo, expr: ast.AST) -> bool:
        """``nn.Linear(...)``, ``torch.nn.X(...)`` or a project
        ``nn.Module`` subclass instantiated."""
        if not isinstance(expr, ast.Call):
            return False
        d = dotted_name(expr.func) or ""
        full = self.canonical(fi, d) if d else ""
        leaf = d.split(".")[-1]
        return ((full.startswith("torch.nn.") and leaf[:1].isupper()
                 and not full.startswith("torch.nn.functional."))
                or leaf in self.module_classes)

    def _collect_device_attrs(self) -> Set[str]:
        attrs: Set[str] = set()
        for fi in self.functions.values():
            taint = DeviceTaint(self, fi)
            env = taint.build_env()
            for node in _walk_own(fi.node):
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    value = node.value
                    if value is None:
                        continue
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    if taint.is_device(value, env):
                        for t in targets:
                            if isinstance(t, ast.Attribute):
                                attrs.add(t.attr)
        # dataclass field annotations: ``x: Tensor`` in class bodies
        for info in self.modules.values():
            for node in ast.walk(info.tree):
                if isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if (isinstance(sub, ast.AnnAssign)
                                and isinstance(sub.target, ast.Name)
                                and annotation_is_tensor(sub.annotation)):
                            attrs.add(sub.target.id)
        return attrs

    def canonical(self, fi: FunctionInfo, dotted: str) -> str:
        """Resolve the first segment of a dotted path through the
        module's import aliases: ``F.silu`` ->
        ``torch.nn.functional.silu``."""
        root, _, rest = dotted.partition(".")
        root = self.modules[fi.module].imports.get(root, root)
        return f"{root}.{rest}" if rest else root


def _walk_own(fn_node: ast.AST):
    """Walk a function (its signature and body) WITHOUT descending into
    nested function or class definitions (yielding the nested
    definitions themselves); lambdas count as the function's own."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def walk_own(fn_node: ast.AST):
    """``_walk_own`` without the nested definitions' headers: the nodes a
    function's own body evaluates."""
    for node in _walk_own(fn_node):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            yield node


_CONTAINER_CALLS = {"zip", "enumerate", "list", "tuple", "dict", "sorted",
                    "range", "reversed", "set", "map", "filter"}
_CONTAINER_METHODS = {"items", "values", "keys", "unbind", "split", "chunk",
                      "tensor_split"}
_BOOL_METHODS = {"bool", "isnan", "isinf", "isfinite", "logical_and",
                 "logical_or", "logical_not", "logical_xor", "eq", "ne", "lt",
                 "le", "gt", "ge", "isin", "signbit"}
_BOOL_OPS = (ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE)


class DeviceTaint:
    """Per-function tensor classifier over a name environment."""

    def __init__(self, project: Project, fi: FunctionInfo):
        self.project = project
        self.fi = fi
        self.containers: Set[str] = set()    # names bound to Python containers
        self.bools: Set[str] = set()         # names bound to bool tensors
        self.modules: Set[str] = set()       # names bound to nn.Modules

    # -- environment ---------------------------------------------------
    def build_env(self) -> Set[str]:
        """Names holding tensors.  Two forward passes approximate
        loop-carried flow; the LAST binding of a name wins (rebinding a
        name to a host value cleans it).  A nested def starts from its
        enclosing def's environment (the closure)."""
        env: Set[str] = set()
        if self.fi.parent is not None:
            outer = DeviceTaint(self.project,
                                self.project.functions[self.fi.parent])
            env |= outer.build_env()
            self.containers |= outer.containers
            self.bools |= outer.bools
            self.modules |= outer.modules
        args = self.fi.node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if annotation_is_tensor(a.annotation):
                env.add(a.arg)
            else:
                env.discard(a.arg)
        for _ in range(2):
            self._pass_stmts(self.fi.node.body, env)
        return env

    def _bind(self, target: ast.AST, value: Optional[ast.AST], device: bool,
              env: Set[str]) -> None:
        if isinstance(target, ast.Name):
            (env.add if device else env.discard)(target.id)
            for names, flag in (
                    (self.containers, value is not None
                     and self.is_container(value)),
                    (self.bools, value is not None and device
                     and self.is_bool_tensor(value, env)),
                    (self.modules, value is not None
                     and self.project.is_module_ctor(self.fi, value))):
                (names.add if flag else names.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, None, device, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, None, device, env)
        elif isinstance(target, ast.Subscript) and device:
            # storing a tensor INTO a container taints the container
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name):
                env.add(base.id)

    def _pass_stmts(self, stmts, env: Set[str]) -> None:
        for st in stmts:
            if isinstance(st, ast.Assign):
                dev = self.is_device(st.value, env)
                for t in st.targets:
                    self._bind(t, st.value, dev, env)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._bind(st.target, st.value,
                           self.is_device(st.value, env), env)
            elif isinstance(st, ast.AugAssign):
                if self.is_device(st.value, env):
                    self._bind(st.target, None, True, env)
            elif isinstance(st, ast.For):
                if self.is_device(st.iter, env):
                    self._bind(st.target, None, True, env)
                self._pass_stmts(st.body + st.orelse, env)
            elif isinstance(st, (ast.While, ast.If)):
                self._pass_stmts(st.body + st.orelse, env)
            elif isinstance(st, ast.With):
                self._pass_stmts(st.body, env)
            elif isinstance(st, ast.Try):
                self._pass_stmts(st.body + st.orelse + st.finalbody, env)
                for h in st.handlers:
                    self._pass_stmts(h.body, env)

    # -- classification ------------------------------------------------
    def is_container(self, expr: ast.AST) -> bool:
        """A Python container of (maybe) tensors, whose iteration reads
        nothing back: a display, a comprehension, ``zip`` / ``enumerate``
        and friends, ``.items()`` / ``.values()`` / ``.unbind()``."""
        if isinstance(expr, (ast.List, ast.Tuple, ast.Set, ast.Dict,
                             ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            return True
        if isinstance(expr, ast.Name):
            return expr.id in self.containers
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name):
                return expr.func.id in _CONTAINER_CALLS
            if isinstance(expr.func, ast.Attribute):
                return expr.func.attr in _CONTAINER_METHODS
        return False

    def is_bool_tensor(self, expr: ast.AST, env: Set[str]) -> bool:
        """A boolean tensor: a comparison of tensors, ``.bool()``,
        ``torch.isnan`` / ``logical_*``, ``~`` / ``&`` / ``|`` of one."""
        if isinstance(expr, ast.Name):
            return expr.id in self.bools
        if isinstance(expr, ast.Compare):
            return (all(isinstance(op, _BOOL_OPS) for op in expr.ops)
                    and self.is_device(expr, env))
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
            return self.is_bool_tensor(expr.operand, env)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return (self.is_bool_tensor(expr.left, env)
                    or self.is_bool_tensor(expr.right, env))
        if isinstance(expr, ast.Call) and self.is_device(expr, env):
            d = dotted_name(expr.func) or ""
            leaf = d.split(".")[-1] if d else getattr(expr.func, "attr", "")
            if leaf in _BOOL_METHODS:
                return True
            if leaf == "to":
                return any(dotted_name(a) in ("torch.bool", "bool")
                           for a in list(expr.args)
                           + [k.value for k in expr.keywords])
        return False

    def is_device(self, expr: ast.AST, env: Set[str]) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in env
        if isinstance(expr, ast.Attribute):
            if expr.attr in HOST_META_ATTRS:
                return False
            return (expr.attr in self.project.device_attrs
                    or self.is_device(expr.value, env))
        if isinstance(expr, ast.Subscript):
            return self.is_device(expr.value, env)
        if isinstance(expr, ast.Call):
            return self._call_device(expr, env)
        if isinstance(expr, ast.BinOp):
            return (self.is_device(expr.left, env)
                    or self.is_device(expr.right, env))
        if isinstance(expr, ast.UnaryOp):
            return (not isinstance(expr.op, ast.Not)
                    and self.is_device(expr.operand, env))
        if isinstance(expr, ast.Compare):
            # ``x is None``, ``k in d``: Python bools
            return (all(isinstance(op, _BOOL_OPS) for op in expr.ops)
                    and (self.is_device(expr.left, env)
                         or any(self.is_device(c, env)
                                for c in expr.comparators)))
        if isinstance(expr, ast.BoolOp):
            return any(self.is_device(v, env) for v in expr.values)
        if isinstance(expr, ast.IfExp):
            return (self.is_device(expr.body, env)
                    or self.is_device(expr.orelse, env))
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_device(e, env) for e in expr.elts)
        if isinstance(expr, ast.Dict):
            return any(v is not None and self.is_device(v, env)
                       for v in expr.values)
        if isinstance(expr, ast.NamedExpr):
            return self.is_device(expr.value, env)
        if isinstance(expr, ast.Starred):
            return self.is_device(expr.value, env)
        if isinstance(expr, (ast.DictComp, ast.ListComp, ast.SetComp,
                             ast.GeneratorExp)):
            val = expr.value if isinstance(expr, ast.DictComp) else expr.elt
            return self.is_device(val, env)
        return False

    def _call_device(self, call: ast.Call, env: Set[str]) -> bool:
        d = dotted_name(call.func)
        if d:
            full = self.project.canonical(self.fi, d)
            if full in HOST_SAFE_CALLS or full.startswith(HOST_SAFE_PREFIXES):
                return False
            if full.startswith("torch."):
                return True
            if full.startswith("numpy.") or full == "numpy":
                return False
            if d in self.modules:
                return True
        targets = self.project.resolve_call(self.fi, call)
        if targets & self.project.returns_device:
            return True
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in HOST_RESULT_METHODS or attr in HOST_META_METHODS:
                return False
            if attr == "to" and is_cpu_target(call):
                return False
            if attr in self.project.module_attrs:
                return True
            # method call on a tensor: x.float(), x.reshape(...)
            if self.is_device(call.func.value, env):
                return True
        return False


def is_cpu_target(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    for a in list(call.args[:1]) + [k.value for k in call.keywords
                                    if k.arg == "device"]:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and dotted_name(a.func)
                in ("torch.device", "device") and a.args
                and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False
