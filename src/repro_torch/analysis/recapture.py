"""Checker 2: recapture hazards around the captured decode step (the
counterpart of the reference's ``analysis/recompile.py``).

The port's compile cache is ``DecodeGraphs.steps`` (``serving/capture.py``):
one CUDA graph per (decode width, kernel flag), captured at first use.
A width that varies with a runtime shape silently turns steps into
fresh captures (each a warm-up forward and a capture, tens of
milliseconds, plus graph-pool memory that is never given back).

  RC001  ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
         ``torch.cuda.make_graphed_callables(...)`` or
         ``torch.compile(...)`` constructed in a function body outside
         the capture paths (``serving/capture.py``,
         ``training/capture.py``): a graph or compiled wrapper per call
  RC002  a width or shape fed to ``DecodeGraphs.warm`` /
         ``DecodeEngine.warm_decode`` is derived from a runtime shape
  RC003  a token tensor with shape-derived dimensions fed to
         ``DecodeGraphs.replay`` / ``DecodeEngine.decode_slots`` /
         ``ServingLoop.shared_forward`` (the scheduler's pass-through to
         ``decode_slots``): one graph per distinct width

"Shape-derived" taint is STICKY (a branch that taints a name keeps it
tainted — the hazard exists if ANY path produces a varying shape) and is
cleansed only by the bucketing helpers (functions whose name contains
"bucket") and the budget's width table (the adapters' ``width``, which
clamps to the loop's ``max_width``; ``width_grid``): exactly the
sanctioned ways to turn an unbounded shape family into a small graph
set.  Inside the sinks themselves nothing is checked: they pass their
caller's width on.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.callgraph import (FunctionInfo, Project,
                                            dotted_name, walk_own)
from repro_torch.analysis.findings import (Finding, pragma_allows,
                                           scan_pragmas, snippet_of)

CHECKER = "recapture-hazard"

#: modules whose functions may construct graphs (the capture path)
CAPTURE_MODULES = ("repro_torch.serving.capture",
                   "repro_torch.training.capture")
_GRAPH_CTORS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                "torch.cuda.graphs.CUDAGraph", "torch.cuda.graphs.graph",
                "torch.cuda.make_graphed_callables", "torch.compile"}
#: ``Class.method`` -> (checked positional index, its name, rule)
SINKS: Dict[str, Tuple[int, str, str]] = {
    "DecodeGraphs.warm": (0, "shape", "RC002"),
    "DecodeEngine.warm_decode": (0, "widths", "RC002"),
    "DecodeGraphs.replay": (0, "tokens", "RC003"),
    "DecodeEngine.decode_slots": (0, "tokens", "RC003"),
    "ServingLoop.shared_forward": (0, "tokens", "RC003"),
}
_CLEANSERS = {"width", "width_grid"}
_ARRAY_CTORS = {"zeros", "ones", "full", "empty", "arange", "new_zeros",
                "new_ones", "new_full", "new_empty", "randint", "rand",
                "randn"}
_PROPAGATING = {"concatenate", "cat", "pad", "stack", "repeat", "tile",
                "append", "asarray", "array", "as_tensor", "tensor",
                "from_numpy", "broadcast_to", "reshape", "view", "expand",
                "to", "contiguous", "long", "int", "cuda", "clone"}
_SHAPE_METHODS = {"size", "numel", "dim"}


def check(project: Project, capture_modules=CAPTURE_MODULES
          ) -> List[Finding]:
    """Scan EVERY project function (a hazard outside the hot path still
    fills the graph cache the hot path shares)."""
    out: List[Finding] = []
    for qual in sorted(project.functions):
        out.extend(_check_function(project, project.functions[qual],
                                   capture_modules))
    return out


class _ShapeTaint:
    """Sticky shape-derived / dynamic-shape-array name sets."""

    def __init__(self, project: Project, fi: FunctionInfo):
        self.project = project
        self.fi = fi
        self.shape_vars: Set[str] = set()   # host scalars derived of shapes
        self.dyn_vars: Set[str] = set()     # arrays with derived dimensions

    def build(self) -> None:
        for _ in range(2):
            self._pass(self.fi.node.body)

    # -- classification ------------------------------------------------
    @staticmethod
    def _cleansed(call: ast.Call) -> bool:
        d = dotted_name(call.func) or getattr(call.func, "attr", "")
        leaf = d.split(".")[-1]
        return "bucket" in leaf or leaf in _CLEANSERS

    def shape_derived(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Attribute):
            return expr.attr == "shape" or self.shape_derived(expr.value)
        if isinstance(expr, ast.Name):
            return expr.id in self.shape_vars
        if isinstance(expr, ast.Subscript):
            return self.shape_derived(expr.value)
        if isinstance(expr, ast.Call):
            if self._cleansed(expr):
                return False
            d = dotted_name(expr.func) or ""
            if d == "len" or d.endswith(".shape"):
                return True
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in _SHAPE_METHODS:
                    return True
                # method calls on a tainted receiver stay tainted
                if self.shape_derived(expr.func.value):
                    return True
            # calls propagate taint from their arguments (min / max /
            # round_up of a shape-derived value is still shape-derived)
            return any(self.shape_derived(a) for a in expr.args)
        if isinstance(expr, ast.BinOp):
            return (self.shape_derived(expr.left)
                    or self.shape_derived(expr.right))
        if isinstance(expr, ast.UnaryOp):
            return self.shape_derived(expr.operand)
        if isinstance(expr, ast.IfExp):
            return (self.shape_derived(expr.body)
                    or self.shape_derived(expr.orelse))
        if isinstance(expr, ast.Slice):
            return any(e is not None and self.shape_derived(e)
                       for e in (expr.lower, expr.upper, expr.step))
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.shape_derived(e) for e in expr.elts)
        if isinstance(expr, ast.Dict):
            return any(v is not None and self.shape_derived(v)
                       for v in expr.values)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            if any(self._iter_tainted(g.iter) for g in expr.generators):
                return True
            val = expr.value if isinstance(expr, ast.DictComp) else expr.elt
            return self.shape_derived(val)
        return False

    def _iter_tainted(self, it: ast.AST) -> bool:
        return self.shape_derived(it) or self.dynamic_array(it)

    def dynamic_array(self, expr: ast.AST) -> bool:
        """Array-valued expression with a shape-derived dimension."""
        if isinstance(expr, ast.Name):
            return expr.id in self.dyn_vars
        if isinstance(expr, ast.Subscript):
            # x[:n] with a derived bound IS a dynamic slice
            if self.shape_derived(expr.slice):
                return True
            return self.dynamic_array(expr.value)
        if isinstance(expr, ast.Call):
            d = dotted_name(expr.func) or getattr(expr.func, "attr", "")
            leaf = d.split(".")[-1]
            if leaf in _ARRAY_CTORS:
                if any(self.shape_derived(a) for a in expr.args):
                    return True
            if leaf in _PROPAGATING or leaf in _ARRAY_CTORS:
                if any(self.dynamic_array(a) or self.shape_derived(a)
                       for a in expr.args):
                    return True
                if (isinstance(expr.func, ast.Attribute)
                        and self.dynamic_array(expr.func.value)):
                    return True
            return False
        if isinstance(expr, ast.BinOp):
            return (self.dynamic_array(expr.left)
                    or self.dynamic_array(expr.right))
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.dynamic_array(e) for e in expr.elts)
        return False

    # -- sticky environment --------------------------------------------
    def _mark(self, target: ast.AST, shape: bool, dyn: bool) -> None:
        if isinstance(target, ast.Name):
            if shape:
                self.shape_vars.add(target.id)
            if dyn:
                self.dyn_vars.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark(e, shape, dyn)
        elif isinstance(target, ast.Starred):
            self._mark(target.value, shape, dyn)

    def _pass(self, stmts) -> None:
        for st in stmts:
            if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = st.value
                if value is None:
                    continue
                targets = (st.targets if isinstance(st, ast.Assign)
                           else [st.target])
                shape = self.shape_derived(value)
                dyn = self.dynamic_array(value)
                for t in targets:
                    self._mark(t, shape, dyn)
            elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                # container mutation: d.setdefault(shape_derived, ...) /
                # xs.append(dyn) taints the container
                node, args = st.value, []
                while isinstance(node, ast.Call):
                    args.extend(node.args)
                    node = node.func
                    if isinstance(node, ast.Attribute):
                        if node.attr not in ("append", "setdefault", "add",
                                             "insert", "extend", "update"):
                            break
                        node = node.value
                if isinstance(node, ast.Name):
                    if any(self.shape_derived(a) for a in args):
                        self.shape_vars.add(node.id)
                    if any(self.dynamic_array(a) for a in args):
                        self.dyn_vars.add(node.id)
            elif isinstance(st, ast.For):
                if self._iter_tainted(st.iter):
                    self._mark(st.target, True, False)
                self._pass(st.body + st.orelse)
            elif isinstance(st, (ast.While, ast.If)):
                self._pass(st.body + st.orelse)
            elif isinstance(st, ast.With):
                self._pass(st.body)
            elif isinstance(st, ast.Try):
                self._pass(st.body + st.orelse + st.finalbody)
                for h in st.handlers:
                    self._pass(h.body)


def _check_function(project: Project, fi: FunctionInfo,
                    capture_modules) -> List[Finding]:
    info = project.modules[fi.module]
    pragmas = scan_pragmas(info.source)
    out: List[Finding] = []
    rel = fi.path.relative_to(project.rel_to).as_posix()

    def emit(node: ast.AST, rule: str, message: str) -> None:
        if pragma_allows(pragmas, node, CHECKER, rule):
            return
        out.append(Finding(CHECKER, rule, rel, node.lineno, fi.qualname,
                           message, snippet_of(info.source, node)))

    # the body only: a decorator (``@torch.compile`` at module scope) is
    # built once; a nested def is checked as its own function
    body = [n for stmt in fi.node.body
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef))
            for n in [stmt, *walk_own(stmt)]]
    if fi.module not in capture_modules:
        for node in body:
            if isinstance(node, ast.Call):
                d = dotted_name(node.func) or ""
                if project.canonical(fi, d) in _GRAPH_CTORS:
                    emit(node, "RC001",
                         f"{d} constructed in a function body outside the "
                         "capture path: a new graph (or compiled wrapper) "
                         "per call — capture through serving.capture's "
                         "DecodeGraphs, which keeps one per width")
    if fi.method_key in SINKS:
        return out
    taint = None
    for node in body:
        if not isinstance(node, ast.Call):
            continue
        sinks = {project.functions[q].method_key
                 for q in project.resolve_call(fi, node)} & set(SINKS)
        for key in sorted(sinks):
            if taint is None:
                taint = _ShapeTaint(project, fi)
                taint.build()
            _check_sink_call(node, key, taint, emit)
    return out


def _check_sink_call(call: ast.Call, key: str, taint: _ShapeTaint,
                     emit) -> None:
    index, name, rule = SINKS[key]
    arg = (call.args[index] if len(call.args) > index
           and not isinstance(call.args[index], ast.Starred)
           else next((k.value for k in call.keywords if k.arg == name),
                     None))
    if arg is None:
        return
    if rule == "RC002" and taint.shape_derived(arg):
        emit(arg, "RC002",
             f"{name!r} of {key}() is derived from a runtime shape: one "
             "captured graph per distinct width — bucket it or take it "
             "from the budget's width table")
    elif rule == "RC003" and taint.dynamic_array(arg):
        emit(arg, "RC003",
             f"{name!r} of {key}() has shape-derived dimensions that "
             "bypass the bucketing and the width table: one captured "
             "graph per distinct width")
