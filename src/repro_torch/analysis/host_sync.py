"""Checker 1: blocking device->host syncs on the port's hot paths (the
counterpart of the reference's ``analysis/host_sync.py``, in torch terms).

Walks every project function reachable from the roots (the serving
loop's step and the engine's decode, the train step, its captured
replay and the AdamW update by default) and flags expressions that make
the host WAIT on the device:

  HS001  int() / float() / bool() of a tensor, or a tensor used as a
         truth value (an ``if`` / ``while`` / ``assert`` test, a
         conditional expression, ``not t``): blocks until the scalar
         materializes
  HS002  np.asarray() / np.array() of a tensor, ``.cpu()``,
         ``.numpy()``, ``.to("cpu")``: a synchronous copy to the host
  HS003  ``.item()`` / ``.tolist()``
  HS004  Python iteration (for / list / sorted / comprehension) over a
         tensor: one indexing op per element, and a readback as soon as
         an element is used as a number
  HS005  ``torch.cuda.synchronize()``, ``Event.synchronize()``,
         ``Stream.synchronize()``: unconditionally
  HS006  an op whose output shape depends on the data, which CUDA can
         only size by reading the data back: ``nonzero`` / ``argwhere``
         / one-argument ``torch.where``, ``bincount``, ``unique``,
         ``masked_select``, ``repeat_interleave`` with tensor repeats and
         no ``output_size``, and indexing by a boolean tensor

Host->device uploads (``torch.as_tensor(host, device=...)``) are NOT
flagged: they are cheap and asynchronous.  Per-step control decisions
read host mirrors (``slot_lens_host``), and device results cross back
once per step through a sanctioned transfer marked with a pragma.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.callgraph import (DeviceTaint, FunctionInfo,
                                            Project, dotted_name,
                                            is_cpu_target, walk_own)
from repro_torch.analysis.findings import (Finding, pragma_allows,
                                           scan_pragmas, snippet_of)

CHECKER = "host-sync"

DEFAULT_ROOTS = (
    "repro_torch.serving.scheduler.ServingLoop.step",
    "repro_torch.serving.engine.DecodeEngine.decode_slots",
    "repro_torch.training.train_step.train_step",
    "repro_torch.training.optimizer.adamw_update",
    "repro_torch.training.capture.TrainGraphs.replay",
    "repro_torch.dist.sharded_train.local_train_step",
    "repro_torch.dist.tensor_parallel.attention",
    "repro_torch.dist.tensor_parallel.embed",
    "repro_torch.dist.tensor_parallel.vocab_parallel_cross_entropy",
    "repro_torch.dist.tensor_parallel.gather_state",
)

_SCALAR_CASTS = {"int", "float", "bool", "complex"}
_ITER_BUILTINS = {"list", "tuple", "sorted", "set", "sum", "max", "min",
                  "enumerate", "zip"}
_NUMPY_PULLS = {"numpy.asarray", "numpy.array", "numpy.copy",
                "numpy.ascontiguousarray"}
# ops whose output size is data-dependent (a device->host read on CUDA)
_DYNAMIC_SHAPE_OPS = {"nonzero", "argwhere", "bincount", "unique",
                      "unique_consecutive", "masked_select"}


def check(project: Project, roots=DEFAULT_ROOTS) -> List[Finding]:
    findings: List[Finding] = []
    hot = project.reachable(roots)
    for qual in sorted(hot):
        fi = project.functions[qual]
        findings.extend(_check_function(project, fi))
    return findings


def _check_function(project: Project, fi: FunctionInfo) -> List[Finding]:
    info = project.modules[fi.module]
    pragmas = scan_pragmas(info.source)
    taint = DeviceTaint(project, fi)
    env = taint.build_env()
    out: List[Finding] = []
    seen: Set[int] = set()

    def emit(node: ast.AST, rule: str, message: str) -> None:
        if id(node) in seen or pragma_allows(pragmas, node, CHECKER, rule):
            return
        seen.add(id(node))
        rel = fi.path.relative_to(project.rel_to).as_posix()
        out.append(Finding(CHECKER, rule, rel, node.lineno, fi.qualname,
                           message, snippet_of(info.source, node)))

    def device(expr: ast.AST) -> bool:
        return taint.is_device(expr, env)

    def iterates_tensor(expr: ast.AST) -> bool:
        return device(expr) and not taint.is_container(expr)

    def truth_test(test: ast.AST) -> None:
        if device(test):
            emit(test, "HS001",
                 "a tensor used as a truth value blocks until its value "
                 "reaches the host; decide on a host mirror")

    def check_call(call: ast.Call) -> None:
        func = call.func
        d = dotted_name(func)
        full = project.canonical(fi, d) if d else ""
        leaf = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        receiver = func.value if isinstance(func, ast.Attribute) else None
        if full == "torch.cuda.synchronize" or (
                receiver is not None and leaf == "synchronize"):
            emit(call, "HS005",
                 f"{d or '.synchronize'}() blocks the host until the "
                 "device (or stream / event) drains")
            return
        on_tensor = receiver is not None and device(receiver)
        torch_fn = full.startswith("torch.")
        if leaf in ("item", "tolist") and on_tensor:
            emit(call, "HS003",
                 f".{leaf}() on a tensor is a blocking readback")
            return
        if on_tensor and (leaf in ("cpu", "numpy")
                          or (leaf == "to" and is_cpu_target(call))):
            emit(call, "HS002",
                 f".{leaf}() of a tensor is a synchronous copy to the "
                 "host; move the computation on-device and transfer one "
                 "small result per step")
            return
        if (leaf in _DYNAMIC_SHAPE_OPS and (torch_fn or on_tensor)) or (
                full == "torch.where" and len(call.args) == 1
                and not call.keywords):
            emit(call, "HS006",
                 f"{leaf}() has a data-dependent output shape, which CUDA "
                 "sizes by reading the data back to the host")
            return
        if leaf == "repeat_interleave" and (torch_fn or on_tensor):
            repeats = (call.args[1] if torch_fn and len(call.args) > 1
                       else call.args[0] if not torch_fn and call.args
                       else next((k.value for k in call.keywords
                                  if k.arg == "repeats"), None))
            if (repeats is not None and device(repeats)
                    and not any(k.arg == "output_size"
                                for k in call.keywords)):
                emit(call, "HS006",
                     "repeat_interleave() with tensor repeats and no "
                     "output_size reads the repeats back to size its "
                     "output")
            return
        if not call.args:
            return
        arg0 = call.args[0]
        if isinstance(func, ast.Name) and func.id in _SCALAR_CASTS:
            if device(arg0):
                emit(call, "HS001",
                     f"{func.id}() of a tensor blocks until the scalar "
                     "reaches the host; keep a host mirror or batch the "
                     "readback")
        elif isinstance(func, ast.Name) and func.id in _ITER_BUILTINS:
            if iterates_tensor(arg0):
                emit(call, "HS004",
                     f"{func.id}() over a tensor iterates it element by "
                     "element; pull once with a sanctioned transfer")
        elif full in _NUMPY_PULLS:
            if device(arg0):
                emit(call, "HS002",
                     f"{d}() of a tensor is a synchronous copy to the "
                     "host; move the computation on-device and transfer "
                     "one small result per step")

    for node in walk_own(fi.node):
        if isinstance(node, ast.Call):
            check_call(node)
        elif isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            truth_test(node.test)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            truth_test(node.operand)
        elif isinstance(node, ast.For) and iterates_tensor(node.iter):
            emit(node.iter, "HS004",
                 "for-loop over a tensor iterates it element by element")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if iterates_tensor(gen.iter):
                    emit(gen.iter, "HS004",
                         "comprehension over a tensor iterates it element "
                         "by element")
                for cond in gen.ifs:
                    truth_test(cond)
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Load) and device(node.value)):
            index = node.slice
            parts = index.elts if isinstance(index, ast.Tuple) else [index]
            if any(taint.is_bool_tensor(p, env) for p in parts):
                emit(node, "HS006",
                     "indexing by a boolean tensor has a data-dependent "
                     "output shape, sized by a readback; use torch.where "
                     "or masked_fill")
    return out
