"""Mesh-axis analyzer (rules AXIS001, AXIS002).

Port of ``repro/analysis/axes.py``.  The port's meshes address their axes
by NAME (``dist/sharding.py``): a typo'd axis name fails only when the
exact mesh shape is run, usually a multi-process gap in testing.  AXIS001
pins every axis-name string literal where a name enters a mesh to
``repro_torch.dist.sharding.AXIS_VOCAB``.  Those places are
``dist/mesh.py::make_mesh(shape, names)``, a mesh description
``dist/sharding.py::Mesh(axis_names, axis_sizes)``, ``HostMesh.axis(name)``
and ``.axes(names)`` (any ``.axis``/``.axes`` method call handed a string
literal: the receiver's type is not known statically), and the axes
argument of the ``dist/collectives.py`` functions.

AXIS002 is the counterpart of the reference's shard_map spec arity:
``dist/launch.py::spawn(fn, world, *args, device=None)`` runs ``fn(rank,
world, *args)`` in each rank, so where ``fn`` names a plain ``def`` without
``*args`` (in the same file, or in a module beside it imported by name),
its positional parameters must take ``2 + len(args)`` arguments.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, FrozenSet, List, Optional

from repro_torch.analysis.astutil import (ImportTable, literal_str_elements,
                                          resolve_call)
from repro_torch.analysis.findings import Finding

# Fallback when repro_torch.dist.sharding cannot import (a test holds it
# equal to AXIS_VOCAB).
_DEFAULT_VOCAB = frozenset({"data", "pod", "model", "tensor", "tp", "mp"})

# dotted origin -> (positional index of the axis-name argument, kwarg name)
_COLL = "repro_torch.dist.collectives."
_NAME_TAKERS: Dict[str, tuple] = {
    "repro_torch.dist.mesh.make_mesh": (1, "names"),
    "repro_torch.dist.sharding.Mesh": (0, "axis_names"),
    _COLL + "axis_size": (0, "axes"),
    _COLL + "all_gather_axes": (1, "axes"),
    _COLL + "gather_workers": (1, "worker_axes"),
    _COLL + "all_to_all_scatter": (1, "worker_axes"),
    _COLL + "gather_slices": (1, "worker_axes"),
    _COLL + "worker_slice_index": (0, "worker_axes"),
    _COLL + "psum_axes": (1, "axes"),
    _COLL + "copy_to_model": (1, "axes"),
    _COLL + "reduce_from_model": (1, "axes"),
    _COLL + "gather_from_model": (1, "axes"),
    _COLL + "scatter_to_model": (1, "axes"),
    _COLL + "reduce_scatter_to_model": (1, "axes"),
    _COLL + "fsdp_gather": (1, "axes"),
}
# The package re-exports of the functions above.
for _name in ("axis_size", "all_to_all_scatter", "gather_slices",
              "gather_workers", "psum_axes", "worker_slice_index"):
    _NAME_TAKERS["repro_torch.dist." + _name] = _NAME_TAKERS[_COLL + _name]
_MESH_METHODS = {"axis": (0, "name"), "axes": (0, "names")}

_SPAWN = "repro_torch.dist.launch.spawn"


def axis_vocabulary() -> FrozenSet[str]:
    """The port's mesh-axis vocabulary (imported, with a fallback)."""
    try:
        from repro_torch.dist.sharding import AXIS_VOCAB
        return frozenset(AXIS_VOCAB)
    except ImportError:
        return _DEFAULT_VOCAB


def module_of(path: str) -> Optional[str]:
    """The dotted module name of a file under ``src/repro_torch``."""
    norm = os.path.abspath(path).replace("\\", "/")
    head, sep, tail = norm.rpartition("/src/")
    if not sep or not tail.startswith("repro_torch/") \
            or not tail.endswith(".py"):
        return None
    mod = tail[:-3].replace("/", ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def _origin(call: ast.Call, imports: ImportTable, module: Optional[str],
            local_defs: FrozenSet[str]) -> Optional[str]:
    """A call's dotted origin; a call of a module-level def of this file
    resolves to ``<module>.<name>``."""
    resolved = resolve_call(call, imports)
    if module is not None and isinstance(call.func, ast.Name) \
            and resolved in local_defs:
        return f"{module}.{resolved}"
    return resolved


def _arg(call: ast.Call, pos: int, kwarg: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == kwarg:
            return kw.value
    if len(call.args) > pos:
        return call.args[pos]
    return None


class _Defs:
    """Positional parameters of the plain defs one file can hand to
    ``spawn``: its own, and those of a module beside it that it imports
    names from.  A name bound by several defs is ambiguous and dropped."""

    def __init__(self, path: str, tree: ast.Module):
        self.fns: Dict[str, ast.FunctionDef] = {}
        self._index(tree)
        here = os.path.dirname(os.path.abspath(path))
        for node in tree.body:
            if not (isinstance(node, ast.ImportFrom) and node.level == 0
                    and node.module and "." not in node.module):
                continue
            side = os.path.join(here, node.module + ".py")
            if not os.path.isfile(side):
                continue
            try:
                with open(side, encoding="utf-8") as fh:
                    other = _Defs.top_defs(ast.parse(fh.read()))
            except (OSError, SyntaxError):
                continue
            for a in node.names:
                if a.name in other and (a.asname or a.name) not in self.fns:
                    self.fns[a.asname or a.name] = other[a.name]

    @staticmethod
    def top_defs(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
        return {n.name: n for n in tree.body
                if isinstance(n, ast.FunctionDef)}

    def _index(self, tree: ast.Module) -> None:
        counts: Dict[str, int] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                counts[node.name] = counts.get(node.name, 0) + 1
                self.fns[node.name] = node
        for name, n in counts.items():
            if n > 1:
                del self.fns[name]


def analyze(path: str, tree: ast.Module) -> List[Finding]:
    imports = ImportTable(tree)
    vocab = axis_vocabulary()
    module = module_of(path)
    local_defs = frozenset(n.name for n in tree.body
                           if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
    defs: Optional[_Defs] = None
    findings: List[Finding] = []

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        origin = _origin(node, imports, module, local_defs)
        where = _NAME_TAKERS.get(origin)
        if where is None and isinstance(node.func, ast.Attribute):
            where = _MESH_METHODS.get(node.func.attr)
            origin = f".{node.func.attr}"
        if where is not None:
            arg = _arg(node, *where)
            literals = [] if arg is None else literal_str_elements(arg)[0]
            for value, lineno in literals:
                if value not in vocab:
                    findings.append(Finding(
                        rule="AXIS001", path=path, line=lineno,
                        message=f"axis name {value!r} handed to "
                                f"{origin.rsplit('.', 1)[-1]}() is not in "
                                "the dist/sharding.py vocabulary "
                                f"{sorted(vocab)}",
                        hint="use an axis name from repro_torch.dist."
                             "sharding.AXIS_VOCAB (or add the new role "
                             "there first)"))
        elif origin == _SPAWN:
            if defs is None:
                defs = _Defs(path, tree)
            findings.extend(_check_spawn(path, node, defs))
    return findings


def _check_spawn(path: str, call: ast.Call, defs: _Defs) -> List[Finding]:
    # spawn's one keyword, ``device``, is not handed to the rank function
    if len(call.args) < 2 or not isinstance(call.args[0], ast.Name) \
            or any(k.arg != "device" for k in call.keywords) \
            or any(isinstance(a, ast.Starred) for a in call.args):
        return []
    fname = call.args[0].id
    fn = defs.fns.get(fname)
    if fn is None or fn.args.vararg is not None:
        return []
    a = fn.args
    total = len(a.posonlyargs) + len(a.args)
    required = total - len(a.defaults)
    given = len(call.args)          # fn, world, *args -> rank, world, *args
    kw_required = [k.arg for k, d in zip(a.kwonlyargs, a.kw_defaults)
                   if d is None]
    if required <= given <= total and not kw_required:
        return []
    takes = str(total) if required == total else f"{required} to {total}"
    extra = (f" and keyword-only {kw_required} without defaults"
             if kw_required else "")
    return [Finding(
        rule="AXIS002", path=path, line=call.lineno,
        message=f"spawn hands {fname}(rank, world, *args) {given - 2} "
                f"args ({given} positional arguments in all), but "
                f"{fname}() takes {takes}{extra}",
        hint="pass spawn one argument per parameter of the rank function "
             "after (rank, world)")]
