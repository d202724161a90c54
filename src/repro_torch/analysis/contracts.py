"""Plugin-contract conformance (CONTRACT001-009, 011, 012) and the kernel
caps against the CUDA sources (PALLAS003).

Port of ``repro/analysis/contracts.py``.  The rule, attack, topology and
codec registries carry metadata the whole stack dispatches on:
``emits_scores``, ``has_kernel``, ``supports_streaming``, ``fused_gate``,
``uses_b``/``uses_q``, attack ``step_aware``, topology ``param_names`` and
allow-lists, codec ``stateful``.  A drifted flag surfaces as a silent wrong
answer or a crash in the middle of a sweep.  This analyzer imports the
port's registries and inspects every registered plugin:

* CONTRACT001: ``emits_scores`` <=> ``reduce_sharded_with_scores`` is
  overridden below :class:`AggregatorRule`.
* CONTRACT002: ``has_kernel`` <=> ``_reduce_kernel`` is overridden below
  it; and every ``repro_torch.kernels.ops`` function the rule's methods
  reach exists and is built from a ``kernels/build.py::SOURCES`` entry
  whose ``csrc/<name>.cu`` is in the checkout.
* CONTRACT003: ``supports_streaming`` <=> the rule is in
  ``train/streaming.py::STREAMING_IMPL_RULES`` (both directions).
* CONTRACT004: ``uses_b``/``uses_q`` <=> the rule's own methods read
  ``params.b``/``params.q``.
* CONTRACT005: every attack factory's closure is ``(gen, u[, step=None])``
  (third argument iff ``step_aware``).
* CONTRACT006: topology ``param_names`` equals the literal
  ``topology_params`` keys its source reads.
* CONTRACT007: ``fused_gate`` <=> ``reduce_sharded_gated_with_scores`` is
  overridden.
* CONTRACT008: topology ``attack_allowlist`` and ``STREAMING_ATTACKS``
  entries name registered attacks.
* CONTRACT009: ``serve/cache.py::BlockAllocator`` never hands out the
  reserved null block 0 and refuses to take it back.  (The reference's
  other half, the f32 TPU sublane and ``DEFAULT_TILE_D``, has no meaning
  on the GPU.)
* CONTRACT011: topology ``fault_allowlist`` entries name registered fault
  kinds, and fault support is declared <=> ``run()`` reads ``plan.faults``.
* CONTRACT012: codecs implement ``encode``/``decode``/``payload_bytes``
  below :class:`Codec`, and ``stateful`` <=> ``init_state`` is overridden.
* PALLAS003: the kernels' caps in ``kernels/build.py`` against the CUDA
  sources, read as text (no compiler needed): ``REGISTER_BUCKETS`` against
  ``selection.cuh``'s ``next_bucket`` and ``kRegisterMaxM``,
  ``WARP_SORT_MAX_M`` against ``kWarpSortMaxM``, ``GRAM_TILE`` against
  ``kGramTile``, ``DTYPE_CODES`` against ``kF32``/``kF16``/``kBF16``; every
  ``SOURCES`` entry has its ``.cu`` and every ``MAX_M`` key is a source;
  each kernel package's ``ref.py`` exports a ``*_ref`` function.

``check_registry()`` audits everything registered; ``check_module(path)``
imports one file and audits the plugin classes it defines, without
registering them.
"""
from __future__ import annotations

import ast
import functools
import importlib
import importlib.util
import inspect
import os
import re
import sys
import textwrap
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from repro_torch.analysis.astutil import ImportTable, dotted_name
from repro_torch.analysis.findings import Finding


def _anchor(obj) -> Tuple[str, int]:
    """(relative path, definition line) for a class/function anchor."""
    try:
        path = inspect.getsourcefile(obj) or "<unknown>"
        line = inspect.getsourcelines(obj)[1]
    except (OSError, TypeError):
        return "<unknown>", 1
    try:
        rel = os.path.relpath(path)
        if not rel.startswith(".."):
            path = rel
    except ValueError:
        pass
    return path, line


def _defining_class(cls: type, name: str) -> Optional[type]:
    for k in cls.__mro__:
        if name in k.__dict__:
            return k
    return None


def _overridden(cls: type, base: type, name: str) -> bool:
    """Is ``name`` implemented below ``base`` in ``cls``'s MRO?"""
    owner = _defining_class(cls, name)
    return owner is not None and owner is not base \
        and issubclass(owner, base)


def _own_functions(cls: type, base: type) -> list:
    """Every function ``cls`` defines below ``base`` (shared intermediate
    bases such as ``_TrimFamilyRule`` count: their methods are the
    subclass's)."""
    fns = []
    for k in cls.__mro__:
        if k is base or not issubclass(k, base):
            continue
        for obj in vars(k).values():
            fn = getattr(obj, "__func__", obj)
            if inspect.isfunction(fn):
                fns.append(fn)
    return fns


def _source(fn) -> str:
    try:
        return inspect.getsource(fn)
    except (OSError, TypeError):
        return ""


# ---------------------------------------------------------------------------
# Rule checks
# ---------------------------------------------------------------------------

def _check_rule(cls) -> List[Finding]:
    from repro_torch.core.registry import AggregatorRule
    findings: List[Finding] = []
    path, line = _anchor(cls)
    name = getattr(cls, "name", cls.__name__)

    def finding(rule: str, msg: str, hint: str) -> None:
        findings.append(Finding(rule=rule, path=path, line=line,
                                message=f"rule {name!r}: {msg}", hint=hint))

    own = _own_functions(cls, AggregatorRule)
    src = "\n".join(_source(fn) for fn in own)

    scores = _overridden(cls, AggregatorRule, "reduce_sharded_with_scores")
    if cls.emits_scores and not scores:
        finding("CONTRACT001",
                "emits_scores=True but reduce_sharded_with_scores is the "
                "uninformative base default",
                "override reduce_sharded_with_scores (or drop "
                "emits_scores)")
    elif scores and not cls.emits_scores:
        finding("CONTRACT001",
                "reduce_sharded_with_scores is overridden but "
                "emits_scores=False hides it from score_rules()",
                "set emits_scores = True")

    kernel = _overridden(cls, AggregatorRule, "_reduce_kernel")
    if cls.has_kernel and not kernel:
        finding("CONTRACT002",
                "has_kernel=True but _reduce_kernel is not implemented",
                "implement _reduce_kernel dispatching to "
                "repro_torch.kernels.ops")
    elif kernel and not cls.has_kernel:
        owner = _defining_class(cls, "_reduce_kernel")
        finding("CONTRACT002",
                f"_reduce_kernel exists (on {owner.__name__}) but "
                "has_kernel=False keeps backend='pallas' unreachable",
                "set has_kernel = True, or move the hook off the class "
                "this rule inherits it from")
    if cls.has_kernel and kernel:
        for msg, hint in _kernel_dispatch_problems(cls, own):
            finding("CONTRACT002", msg, hint)

    fused = _overridden(cls, AggregatorRule,
                        "reduce_sharded_gated_with_scores")
    if getattr(cls, "fused_gate", False) and not fused:
        finding("CONTRACT007",
                "fused_gate=True but reduce_sharded_gated_with_scores is "
                "the two-pass base composition",
                "override the gated hook with a one-pass implementation "
                "(or drop fused_gate)")
    elif fused and not getattr(cls, "fused_gate", False):
        finding("CONTRACT007",
                "reduce_sharded_gated_with_scores is overridden but "
                "fused_gate=False mislabels the defense routing",
                "set fused_gate = True so the conformance metadata "
                "matches the one-pass path")

    if cls.supports_streaming:
        from repro_torch.train.streaming import STREAMING_IMPL_RULES
        if name not in STREAMING_IMPL_RULES:
            finding("CONTRACT003",
                    "supports_streaming=True but train/streaming.py has "
                    "no streaming formulation for it "
                    f"(STREAMING_IMPL_RULES={sorted(STREAMING_IMPL_RULES)})",
                    "add the streaming formulation or drop "
                    "supports_streaming")

    reads_b = re.search(r"params\.b\b", src) is not None
    reads_q = re.search(r"params\.q\b", src) is not None
    for flag, reads, pname in (("uses_b", reads_b, "b"),
                               ("uses_q", reads_q, "q")):
        declared = getattr(cls, flag)
        if declared and not reads:
            finding("CONTRACT004",
                    f"{flag}=True but no method reads params.{pname}",
                    f"read self.params.{pname} or drop {flag}")
        elif reads and not declared:
            finding("CONTRACT004",
                    f"methods read params.{pname} but {flag}=False hides "
                    "the dependency from spec validation",
                    f"set {flag} = True")
    return findings


def _ops_names(cls: type, fns: list) -> Tuple[List[str], List[str]]:
    """The ``repro_torch.kernels.ops`` functions the methods ``fns`` name:
    ``ops.<name>``, ``getattr(ops, self.<attr>)`` and ``getattr(ops,
    f"{self.<attr>}...")`` with the class's attribute substituted.
    Returns ``(names, unresolved)``."""
    names: List[str] = []
    unresolved: List[str] = []
    for fn in fns:
        text = textwrap.dedent(_source(fn))
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "ops":
                names.append(node.attr)
            elif isinstance(node, ast.Call) \
                    and dotted_name(node.func) == "getattr" \
                    and len(node.args) >= 2 \
                    and dotted_name(node.args[0]) == "ops":
                value = _class_str(cls, node.args[1])
                if value is None:
                    unresolved.append(ast.unparse(node.args[1]))
                else:
                    names.append(value)
    return names, unresolved


def _class_str(cls: type, expr: ast.expr) -> Optional[str]:
    """A string expression's value with ``self.<attr>`` taken from the
    class: a literal, ``self.<attr>`` or an f-string of those."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    name = dotted_name(expr)
    if name is not None and name.startswith("self.") and name.count(".") == 1:
        value = getattr(cls, name[len("self."):], None)
        return value if isinstance(value, str) else None
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for v in expr.values:
            part = _class_str(cls, v.value) \
                if isinstance(v, ast.FormattedValue) else _class_str(cls, v)
            if part is None:
                return None
            parts.append(part)
        return "".join(parts)
    return None


def _kernel_dispatch_problems(cls: type, fns: list) -> List[Tuple[str, str]]:
    from repro_torch.kernels import build, ops
    names, unresolved = _ops_names(cls, fns)
    problems = [(f"dispatches to repro_torch.kernels.ops through {expr!r}, "
                 "which the check cannot resolve",
                 "name the ops function, or through a str class attribute")
                for expr in unresolved]
    if not names and not unresolved:
        problems.append(("its methods reach no repro_torch.kernels.ops "
                         "function",
                         "dispatch _reduce_kernel to repro_torch.kernels.ops"))
    for op in sorted(set(names)):
        if not inspect.isfunction(getattr(ops, op, None)):
            problems.append((f"dispatches to repro_torch.kernels.ops.{op}, "
                             "which does not exist",
                             "add the entry point to kernels/ops.py or fix "
                             "the name"))
            continue
        sources = launched_sources("repro_torch.kernels.ops", op)
        if not sources:
            problems.append((f"repro_torch.kernels.ops.{op} launches no "
                             "kernel built from kernels/build.py::SOURCES",
                             "launch the kernel through build.launch*"))
        for s in sorted(sources):
            if s not in build.SOURCES:
                problems.append((f"ops.{op} launches {s!r}, not a "
                                 "kernels/build.py::SOURCES entry",
                                 "add the source to SOURCES"))
            elif not (build.CSRC / f"{s}.cu").is_file():
                problems.append((f"ops.{op} launches {s!r} but "
                                 f"csrc/{s}.cu is not in the checkout",
                                 "add the CUDA source"))
    return problems


@functools.lru_cache(maxsize=None)
def _module_defs(module: str) -> Tuple[Optional[ImportTable],
                                       Dict[str, ast.FunctionDef]]:
    """A ``repro_torch.kernels`` module's imports and top-level defs, from
    its source."""
    try:
        spec = importlib.util.find_spec(module)
    except (ImportError, ValueError):
        return None, {}
    if spec is None or not spec.origin or not spec.origin.endswith(".py"):
        return None, {}
    with open(spec.origin, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=spec.origin)
    return ImportTable(tree), {n.name: n for n in tree.body
                               if isinstance(n, ast.FunctionDef)}


_LAUNCHERS = frozenset({"launch", "library"})


def launched_sources(module: str, fn: str) -> FrozenSet[str]:
    """The kernel sources ``module.fn`` launches: the string literal handed
    to a ``launch(...)``/``library(...)`` call, following calls into the
    ``repro_torch.kernels`` modules (``ops`` -> ``<pkg>/kernel.py`` ->
    ``build.py``)."""
    out = set()
    seen = set()
    todo = [(module, fn)]
    while todo:
        key = todo.pop()
        if key in seen:
            continue
        seen.add(key)
        imports, defs = _module_defs(key[0])
        node = defs.get(key[1])
        if node is None:
            continue
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            callee = dotted_name(call.func)
            if callee is None:
                continue
            if callee.rsplit(".", 1)[-1] in _LAUNCHERS and call.args \
                    and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                out.add(call.args[0].value)
            if "." not in callee and callee in defs:
                todo.append((key[0], callee))
                continue
            full = imports.expand(callee)
            if full.startswith("repro_torch.kernels."):
                todo.append(tuple(full.rsplit(".", 1)))
    return frozenset(out)


def _check_streaming_sync(rule_names: Iterable[str]) -> List[Finding]:
    """The reverse direction of CONTRACT003 (the declared side lives in
    :func:`_check_rule` so module scans cover it): every implemented
    streaming rule must be registered and declare supports_streaming."""
    from repro_torch.core import registry
    from repro_torch.train import streaming
    findings: List[Finding] = []
    names = set(rule_names)
    spath, _ = _anchor(streaming)
    for name in sorted(set(streaming.STREAMING_IMPL_RULES)):
        if name not in names:
            findings.append(Finding(
                rule="CONTRACT003", path=spath, line=1,
                message=f"STREAMING_IMPL_RULES names unregistered rule "
                        f"{name!r}",
                hint="keep STREAMING_IMPL_RULES in sync with the "
                     "registry"))
            continue
        cls = registry.get_rule(name)
        if not cls.supports_streaming:
            path, line = _anchor(cls)
            findings.append(Finding(
                rule="CONTRACT003", path=path, line=line,
                message=f"train/streaming.py implements {name!r} but the "
                        "rule does not declare supports_streaming",
                hint="set supports_streaming = True"))
    return findings


# ---------------------------------------------------------------------------
# Codec checks (CONTRACT012)
# ---------------------------------------------------------------------------

def _check_codec(cls) -> List[Finding]:
    from repro_torch.compress.spec import Codec
    findings: List[Finding] = []
    path, line = _anchor(cls)
    name = getattr(cls, "name", cls.__name__)

    def finding(msg: str, hint: str) -> None:
        findings.append(Finding(rule="CONTRACT012", path=path, line=line,
                                message=f"codec {name!r}: {msg}",
                                hint=hint))

    for method in ("encode", "decode", "payload_bytes"):
        if not _overridden(cls, Codec, method):
            finding(f"{method} is not implemented (the base raises "
                    "NotImplementedError mid-step)",
                    f"implement {method} per the repro_torch.compress.spec "
                    "contract")
    has_state = _overridden(cls, Codec, "init_state")
    if getattr(cls, "stateful", False) and not has_state:
        finding("stateful=True but init_state is the stateless (0,) "
                "placeholder: the error-feedback residual would never "
                "exist",
                "override init_state to return the (m, d) residual (or "
                "drop stateful)")
    elif has_state and not getattr(cls, "stateful", False):
        finding("init_state is overridden but stateful=False hides the "
                "state from checkpointing and topology validation",
                "set stateful = True")
    return findings


# ---------------------------------------------------------------------------
# Attack checks (CONTRACT005)
# ---------------------------------------------------------------------------

def _check_attack(spec) -> List[Finding]:
    from repro_torch.core.attacks import AttackConfig
    findings: List[Finding] = []
    path, line = _anchor(spec.factory)

    def finding(msg: str, hint: str) -> None:
        findings.append(Finding(
            rule="CONTRACT005", path=path, line=line,
            message=f"attack {spec.name!r}: {msg}", hint=hint))

    try:
        closure = spec.factory(AttackConfig(name=spec.name,
                                            num_byzantine=2))
    except Exception as e:  # the factory itself is part of the contract
        finding(f"factory raised {type(e).__name__}: {e}",
                "factories must accept any AttackConfig")
        return findings
    try:
        params = list(inspect.signature(closure).parameters.values())
    except (TypeError, ValueError):
        finding("closure signature is not introspectable",
                "return a plain function/lambda")
        return findings

    positional = [p for p in params if p.kind in
                  (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if len(positional) < 2:
        finding(f"closure takes {len(positional)} positional args; the "
                "contract is (gen, u[, step=None])",
                "accept the torch.Generator and the worker matrix")
    if spec.step_aware:
        step = next((p for p in positional[2:] if p.name == "step"), None)
        if step is None or step.default is not None:
            finding("step_aware=True but the closure lacks a third "
                    "'step=None' parameter",
                    "step-aware closures must accept step=None so "
                    "matrix-level tools can call them stepless")
    else:
        extra = [p for p in positional[2:]
                 if p.default is inspect.Parameter.empty]
        if extra:
            finding("closure requires more than (gen, u) but "
                    "step_aware=False means make_attack only passes two",
                    "default the extra parameters or set step_aware=True")
    return findings


# ---------------------------------------------------------------------------
# Topology checks (CONTRACT006, 008, 011)
# ---------------------------------------------------------------------------

_PARAM_READ_RE = re.compile(
    r"topology_params(?:\.get\(\s*[\"'](\w+)[\"']|\[\s*[\"'](\w+)[\"']\])")


def _check_topology(cls, attack_names: Iterable[str]) -> List[Finding]:
    from repro_torch.faults import available_fault_kinds
    findings: List[Finding] = []
    path, line = _anchor(cls)
    name = getattr(cls, "name", cls.__name__)
    src = _source(cls)

    def finding(rule: str, msg: str, hint: str) -> None:
        findings.append(Finding(rule=rule, path=path, line=line,
                                message=f"topology {name!r} {msg}",
                                hint=hint))

    reads = {a or b for a, b in _PARAM_READ_RE.findall(src)}
    declared = set(cls.param_names)
    for key in sorted(reads - declared):
        finding("CONTRACT006",
                f"reads topology_params[{key!r}] without declaring it in "
                "param_names (spec validation would reject it)",
                f"add {key!r} to param_names")
    for key in sorted(declared - reads):
        finding("CONTRACT006",
                f"declares param_names entry {key!r} that its source never "
                "reads as a literal topology_params key",
                "read it as plan.topology_params.get(\"<key>\", default) "
                "(not through an alias), or drop the stale entry")

    registered = set(attack_names) | {"none", ""}
    for atk in cls.attack_allowlist or ():
        if atk.lower() not in registered:
            finding("CONTRACT008",
                    f"allowlists unregistered attack {atk!r}",
                    "keep attack_allowlist entries registered")

    fault_kinds = set(available_fault_kinds())
    fault_allow = getattr(cls, "fault_allowlist", ())
    for kind in fault_allow or ():
        if kind.lower() not in fault_kinds:
            finding("CONTRACT011",
                    f"allowlists unregistered fault kind {kind!r}",
                    "keep fault_allowlist entries registered in "
                    "repro_torch/faults/spec.py")
    supports_faults = fault_allow is None or bool(fault_allow)
    reads_faults = re.search(r"plan\.faults\b", src) is not None
    if reads_faults and not supports_faults:
        finding("CONTRACT011",
                "injects plan.faults but fault_allowlist=() declares fault "
                "support off (spec validation would reject every fault it "
                "can actually simulate)",
                "declare fault_allowlist (None = all registered kinds)")
    elif supports_faults and not reads_faults:
        finding("CONTRACT011",
                f"declares fault_allowlist={fault_allow!r} but run() never "
                "injects plan.faults",
                "wire make_injector(plan.faults, ...) into run() or set "
                "fault_allowlist = ()")
    return findings


def _check_streaming_attacks(attack_names: Iterable[str]) -> List[Finding]:
    from repro_torch.train import streaming
    findings: List[Finding] = []
    path, _ = _anchor(streaming)
    registered = set(attack_names) | {"none", ""}
    for atk in streaming.STREAMING_ATTACKS:
        if atk.lower() not in registered:
            findings.append(Finding(
                rule="CONTRACT008", path=path, line=1,
                message=f"STREAMING_ATTACKS names unregistered attack "
                        f"{atk!r}",
                hint="keep STREAMING_ATTACKS in sync with the attack "
                     "registry"))
    return findings


# ---------------------------------------------------------------------------
# PALLAS003: the kernels' caps against the CUDA sources
# ---------------------------------------------------------------------------

def _cuda_int(text: str, name: str) -> Optional[int]:
    """The value of ``constexpr int <name> = <int>;`` in a CUDA source."""
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
    return None if m is None else int(m.group(1))


def _cuda_buckets(text: str) -> Optional[List[int]]:
    """``next_bucket``'s steps: ``m <= N ? N : ... : LAST``."""
    m = re.search(r"next_bucket\s*\(\s*int\s+m\s*\)\s*\{\s*return\s+"
                  r"([^;]*);", text)
    if m is None:
        return None
    body = m.group(1)
    pairs = re.findall(r"m\s*<=\s*(\d+)\s*\?\s*(\d+)", body)
    last = re.search(r":\s*(\d+)\s*$", body.strip())
    if not pairs or last is None or any(a != b for a, b in pairs):
        return None
    return [int(b) for _, b in pairs] + [int(last.group(1))]


def _check_kernel_caps() -> List[Finding]:
    import torch
    from repro_torch.kernels import build
    findings: List[Finding] = []
    bpath, _ = _anchor(build)
    with open(inspect.getsourcefile(build), encoding="utf-8") as fh:
        btree = ast.parse(fh.read())
    lines = {t.id: n.lineno for n in btree.body if isinstance(n, ast.Assign)
             for t in n.targets if isinstance(t, ast.Name)}

    def finding(cap: str, msg: str, hint: str) -> None:
        findings.append(Finding(rule="PALLAS003", path=bpath,
                                line=lines.get(cap, 1), message=msg,
                                hint=hint))

    texts: Dict[str, str] = {}
    for fname in ("selection.cuh", "selection_wide.cuh", "krum_gram.cu"):
        try:
            texts[fname] = (build.CSRC / fname).read_text(encoding="utf-8")
        except OSError:
            texts[fname] = ""
            finding("CSRC", f"csrc/{fname} is not readable",
                    "restore the CUDA source")

    def held(cap: str, value, fname: str, cname: str) -> None:
        got = _cuda_int(texts[fname], cname)
        if got is None:
            finding(cap, f"csrc/{fname} defines no constexpr int {cname}",
                    f"keep {cname} a constexpr int in csrc/{fname}")
        elif got != value:
            finding(cap, f"{cap}={value} but csrc/{fname} has "
                         f"{cname} = {got}",
                    f"change both together: {cap} in kernels/build.py and "
                    f"{cname} in csrc/{fname}")

    buckets = tuple(build.REGISTER_BUCKETS)
    held("REGISTER_BUCKETS", max(buckets), "selection.cuh", "kRegisterMaxM")
    steps = _cuda_buckets(texts["selection.cuh"])
    if steps is None:
        finding("REGISTER_BUCKETS", "csrc/selection.cuh's next_bucket is "
                "not of the form 'm <= N ? N : ... : LAST'",
                "keep next_bucket one conditional chain")
    elif tuple(steps) != buckets:
        finding("REGISTER_BUCKETS", f"REGISTER_BUCKETS={buckets} but "
                f"csrc/selection.cuh's next_bucket steps are "
                f"{tuple(steps)}",
                "change both together")
    held("WARP_SORT_MAX_M", build.WARP_SORT_MAX_M, "selection_wide.cuh",
         "kWarpSortMaxM")
    held("GRAM_TILE", build.GRAM_TILE, "krum_gram.cu", "kGramTile")
    for dtype, cname in ((torch.float32, "kF32"), (torch.float16, "kF16"),
                         (torch.bfloat16, "kBF16")):
        held("DTYPE_CODES", build.DTYPE_CODES.get(dtype), "selection.cuh",
             cname)
    for name in build.SOURCES:
        if not (build.CSRC / f"{name}.cu").is_file():
            finding("SOURCES", f"SOURCES entry {name!r} has no "
                    f"csrc/{name}.cu", "add the source or drop the entry")
    for name in sorted(set(build.MAX_M) - set(build.SOURCES)):
        finding("MAX_M", f"MAX_M caps {name!r}, which is not a SOURCES "
                "entry", "keep MAX_M's keys kernel sources")

    for pkg in ("trmean", "phocas", "krum", "flashattn"):
        mod = f"repro_torch.kernels.{pkg}.ref"
        try:
            ref = importlib.import_module(mod)
        except ImportError as e:
            finding("SOURCES", f"kernel oracle module {mod} not importable: "
                    f"{e}", "every kernel package ships a ref.py oracle")
            continue
        if not any(n.endswith("_ref") and inspect.isfunction(f)
                   and f.__module__ == mod for n, f in vars(ref).items()):
            path, _ = _anchor(ref)
            findings.append(Finding(
                rule="PALLAS003", path=path, line=1,
                message=f"{mod} exports no *_ref oracle function",
                hint="name the oracle <kernel>_ref"))
    return findings


def _check_serve_invariants() -> List[Finding]:
    """CONTRACT009: the paged cache's allocator keeps block 0 reserved."""
    from repro_torch.serve import cache as serve_cache
    findings: List[Finding] = []
    path, line = _anchor(serve_cache.BlockAllocator)

    def finding(msg: str, hint: str) -> None:
        findings.append(Finding(rule="CONTRACT009", path=path, line=line,
                                message=msg, hint=hint))

    alloc = serve_cache.BlockAllocator(8)
    if 0 in alloc.alloc(alloc.free_blocks):
        finding("BlockAllocator handed out block 0 (the reserved "
                "null/trash block inactive slots scatter into)",
                "the free list must start at block 1")
    try:
        serve_cache.BlockAllocator(8).free([0])
    except ValueError:
        pass
    else:
        finding("BlockAllocator.free accepted block 0 back into the pool",
                "freeing the reserved null block must raise")
    return findings


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def check_registry() -> List[Finding]:
    """Audit every registered rule, codec, attack and topology, the kernel
    caps and the allocator."""
    from repro_torch.compress.spec import available_codecs, get_codec
    from repro_torch.core import registry
    from repro_torch.experiment import topology as topo_mod

    findings: List[Finding] = []
    rule_names = registry.available_rules()
    attack_names = registry.available_attacks()
    for name in rule_names:
        findings.extend(_check_rule(registry.get_rule(name)))
    findings.extend(_check_streaming_sync(rule_names))
    for name in available_codecs():
        findings.extend(_check_codec(get_codec(name)))
    for name in attack_names:
        findings.extend(_check_attack(registry.get_attack_spec(name)))
    for name in topo_mod.available_topologies():
        findings.extend(_check_topology(topo_mod.get_topology(name),
                                        attack_names))
    findings.extend(_check_streaming_attacks(attack_names))
    findings.extend(_check_kernel_caps())
    findings.extend(_check_serve_invariants())
    return findings


def check_module(path: str) -> List[Finding]:
    """Import one Python file and audit the plugin objects it defines
    (AggregatorRule/Topology/Codec subclasses, AttackSpec instances),
    without registering them: a scan never adds to the process-wide
    registries."""
    from repro_torch.compress.spec import Codec
    from repro_torch.core import registry
    from repro_torch.core.registry import AggregatorRule, AttackSpec
    from repro_torch.experiment.topology import Topology

    modname = "_repro_torch_analysis_scan_" + \
        re.sub(r"\W", "_", os.path.abspath(path))
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        return [Finding(rule="PARSE001", path=path, line=1,
                        message="module not importable for contract scan",
                        hint="pass a Python file")]
    mod = importlib.util.module_from_spec(spec)
    # In sys.modules while it is scanned, so that inspect can anchor
    # findings to real source lines (getsourcefile resolves classes through
    # their module).
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except Exception as e:  # the scanned file is outside input
        del sys.modules[modname]
        return [Finding(rule="PARSE001", path=path, line=1,
                        message=f"import failed during contract scan: "
                                f"{type(e).__name__}: {e}",
                        hint="contract fixtures must import cleanly")]

    findings: List[Finding] = []
    attack_names = registry.available_attacks()
    try:
        for obj in vars(mod).values():
            if isinstance(obj, type) and obj.__module__ == modname:
                if issubclass(obj, AggregatorRule):
                    findings.extend(_check_rule(obj))
                elif issubclass(obj, Topology):
                    findings.extend(_check_topology(obj, attack_names))
                elif issubclass(obj, Codec):
                    findings.extend(_check_codec(obj))
            elif isinstance(obj, AttackSpec):
                findings.extend(_check_attack(obj))
    finally:
        del sys.modules[modname]
    # anchor the scan's findings to the scanned file, not the temp module
    return [Finding(rule=f.rule, path=path, line=f.line, message=f.message,
                    hint=f.hint, severity=f.severity)
            if os.path.abspath(f.path) == os.path.abspath(path) else f
            for f in findings]
