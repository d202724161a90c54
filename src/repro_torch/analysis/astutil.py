"""AST plumbing for the analyzers: import-alias resolution and small
expression helpers.

Port of ``repro/analysis/astutil.py``.  The analyzers match calls by their
*dotted origin* (``torch.manual_seed``, ``repro_torch.dist.mesh.make_mesh``)
however the file imported them (``import torch``, ``from
repro_torch.dist.mesh import make_mesh as mk``).  :class:`ImportTable`
builds the local name -> dotted-path map from a module's import statements;
:func:`resolve_call` turns a ``Call.func`` expression into that path.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple


class ImportTable:
    """Maps local names to the dotted module/attribute paths they alias."""

    def __init__(self, tree: ast.Module):
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    # "import torch.nn as nn" binds nn -> torch.nn;
                    # "import torch.nn" binds torch -> torch.
                    self.aliases[local] = a.name if a.asname \
                        else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def expand(self, dotted: str) -> str:
        """Expand the leading segment of a dotted name via the alias map."""
        head, _, rest = dotted.partition(".")
        base = self.aliases.get(head)
        if base is None:
            return dotted
        return f"{base}.{rest}" if rest else base


def dotted_name(expr: ast.expr) -> Optional[str]:
    """``a.b.c`` attribute chain as a string (None for anything else)."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def resolve_call(call: ast.Call, imports: ImportTable) -> Optional[str]:
    """Dotted origin of a call's callee, alias-expanded."""
    name = dotted_name(call.func)
    return None if name is None else imports.expand(name)


def const_int(expr: ast.expr,
              module_consts: Optional[Dict[str, int]] = None) -> Optional[int]:
    """Static int value of an expression: a literal, a unary minus of one,
    or a Name bound to a module-level int constant."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int) \
            and not isinstance(expr.value, bool):
        return expr.value
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
        inner = const_int(expr.operand, module_consts)
        return None if inner is None else -inner
    if isinstance(expr, ast.Name) and module_consts is not None:
        return module_consts.get(expr.id)
    return None


def module_int_constants(tree: ast.Module) -> Dict[str, int]:
    """Top-level ``NAME = <int literal>`` bindings of a module."""
    consts: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = const_int(node.value)
            if v is not None:
                consts[node.targets[0].id] = v
    return consts


def literal_str_elements(expr: ast.expr) -> Tuple[List[Tuple[str, int]], bool]:
    """String literals inside an axis argument.

    Returns ``(literals, exhaustive)`` where each literal is ``(value,
    lineno)`` and ``exhaustive`` says the expression was fully literal (a
    plain string or a tuple/list of strings) rather than something dynamic.
    """
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [(expr.value, expr.lineno)], True
    if isinstance(expr, (ast.Tuple, ast.List)):
        out: List[Tuple[str, int]] = []
        exhaustive = True
        for elt in expr.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append((elt.value, elt.lineno))
            else:
                exhaustive = False
        return out, exhaustive
    return [], False
