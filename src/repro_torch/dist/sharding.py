"""Mesh-role derivation and partition-spec rules for every model family.

Port of ``repro/dist/sharding.py``.  Pure Python on a mesh description
(axis names and sizes, no devices):

  * worker axes: the paper's m workers (``data``, plus ``pod`` in the
    multi-pod ``("pod", "data", "model")`` mesh); per-worker gradients are
    robust-aggregated across them;
  * model axes: tensor-parallel partitions of the parameters (``model``);
    the vector-wise rules sum their per-vector statistics over them.

:func:`tree_pspecs` turns a parameter tree (nested dicts of tensors, keyed
by the reference's names) into a tree of :class:`P` using the reference's
name and shape rules, with replication wherever a dimension does not divide;
``leaf_rule`` overrides the decision per leaf (:func:`param_pspec_fsdp` is
the FSDP rule); :func:`cache_pspec` is the KV-cache analogue.
:class:`FsdpLayout` places each leaf's FSDP shard (the streaming step's
layout): ``param_pspec_fsdp``'s bytes a rank, cut so that gathering over
the worker axes gives the model-axis block the layers compute on.

:func:`shard_params` and :func:`shard_cache` cut a whole tree to this
rank's blocks by those specs (the reference device-puts it with them);
:func:`init_blocks` builds a model's blocks with the ranks taking turns,
so that no two ranks hold the whole model at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

# Axis names playing the tensor-parallel role; everything else is a worker
# (data-parallel) axis.  Order within each role follows mesh.axis_names.
MODEL_AXIS_NAMES = frozenset({"model", "tensor", "tp", "mp"})

# Worker-role axis names the meshes of this package use.
WORKER_AXIS_NAMES = frozenset({"data", "pod"})

# Every axis name a mesh of this package may carry (the reference's
# vocabulary); ``python -m repro_torch.analysis`` (AXIS001) holds the
# literal names handed to a mesh to it.
AXIS_VOCAB = WORKER_AXIS_NAMES | MODEL_AXIS_NAMES


class P(tuple):
    """A partition spec: one entry per tensor dimension, ``None``
    (replicated), an axis name, or a tuple of axis names (the joint axis),
    as ``jax.sharding.PartitionSpec``.  ``P()`` replicates every dimension.
    """

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh description: axis names and sizes, in row-major order."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def worker_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes playing the paper's worker role, e.g. ``("data",)`` or
    ``("pod", "data")`` on the multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a not in MODEL_AXIS_NAMES)


def model_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """Tensor-parallel mesh axes (``("model",)`` on the standard meshes)."""
    return tuple(a for a in mesh.axis_names if a in MODEL_AXIS_NAMES)


def _axes_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# Linears whose OUTPUT features are model-sharded (column parallel) vs whose
# INPUT features are (row parallel: they consume column-parallel outputs).
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "wi", "wg",            # attention / GLU in-projections
    "wkv_a", "wk_rope", "wk_b", "wv_b",      # MLA projections
    "in_proj", "fc1", "router", "lm_head",   # SSM / VLM / head
})
_ROW_PARALLEL = frozenset({"wo", "out_proj", "fc2"})


def _tp_dim(names: Tuple[str, ...], ndim: int) -> Optional[int]:
    """Which dim of this leaf is model-sharded (None = replicate).

    Works on trailing path names, so the same rules cover bare params,
    optimizer-state copies (``mu/.../wq/w``) and scan-stacked layer blocks
    (a leading period dim shifts the real dims to the END, hence the dims
    counted from the end).
    """
    if ndim < 2:
        return None
    leaf_name = names[-1] if names else ""
    owner = names[-2] if len(names) >= 2 else ""
    if leaf_name == "w":                       # an init_linear leaf
        if owner in _ROW_PARALLEL:
            return ndim - 2                    # contraction (input) features
        return ndim - 1                        # output features
    if leaf_name == "table":                   # embedding: shard the vocab
        return ndim - 2
    if leaf_name in ("moe_wi", "moe_wg"):      # (..., E, d, f): shard f
        return ndim - 1
    if leaf_name == "moe_wo":                  # (..., E, f, d): shard f
        return ndim - 2
    if leaf_name == "conv_w":                  # (width, channels): shard ch
        return ndim - 1
    if leaf_name == "scale":                   # norms
        return None
    return ndim - 1                            # unknown matrices: try last


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts / lists / tuples, keeping its
    structure; ``path`` holds the dict keys and sequence indices as str."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_pspecs(tree, mesh: Mesh, leaf_rule: Optional[Callable] = None):
    """A tree of :class:`P` matching ``tree`` (tensors, or anything with a
    ``shape``).

    ``leaf_rule(name, leaf, mesh) -> P | None`` overrides the default
    tensor-parallel rule per leaf (``name`` is the "/"-joined path);
    returning None falls through to the default.
    """
    model_axes = model_axes_of(mesh)
    tp = _axes_size(mesh, model_axes)

    def spec_of(names, leaf):
        if leaf_rule is not None:
            override = leaf_rule("/".join(names), leaf, mesh)
            if override is not None:
                return override
        shape = tuple(leaf.shape)
        dim = _tp_dim(names, len(shape))
        if (dim is None or tp <= 1 or shape[dim] % tp
                or shape[dim] < tp):
            return P()
        spec = [None] * len(shape)
        spec[dim] = model_axes if len(model_axes) > 1 else model_axes[0]
        return P(*spec)

    return _map_with_path(spec_of, tree)


def spec_leaves(specs) -> list:
    """The :class:`P` leaves of a :func:`tree_pspecs` tree, in the order of
    ``repro_torch.tree.leaves`` over the tree it describes (a P is a tuple,
    so the generic walk would open it)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [x for t in specs for x in spec_leaves(t)]


def param_pspec_fsdp(name: str, leaf, mesh: Mesh) -> Optional[P]:
    """FSDP leaf rule: shard each leaf over the joint (worker, model) device
    set, falling back to ever smaller axis groups until one divides."""
    del name
    shape = tuple(leaf.shape)
    if not shape:
        return P()
    axes = worker_axes_of(mesh) + model_axes_of(mesh)
    # Longest suffix group first (drops the coarsest axes first: a pure
    # 'model' group is the plain TP fallback), largest dims first.
    groups = [axes[i:] for i in range(len(axes))]
    groups += [(a,) for a in axes[:-1]]
    dims = sorted(range(len(shape)), key=lambda d: -shape[d])
    for group in groups:
        size = _axes_size(mesh, group)
        if size <= 1:
            continue
        for d in dims:
            if shape[d] % size == 0 and shape[d] >= size:
                spec = [None] * len(shape)
                spec[d] = group if len(group) > 1 else group[0]
                return P(*spec)
    return P()


# ---------------------------------------------------------------------------
# FSDP layout (the streaming mode's)
# ---------------------------------------------------------------------------

# Parameter subtrees stacked on a leading period (decoder) or layer
# (encoder-decoder) dim, whose layers gather one period at a time.
STACKED_PARAMS = ("stack/blocks/", "enc/", "dec/")


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class FsdpLeaf:
    """Where one leaf's FSDP shard sits.  The layers compute on ``block``
    (the leaf cut over the model axes by ``tree_pspecs``, ``cut`` its
    ``(dim, model axis names)``, or the whole leaf), one period of it when
    ``per_period``; the shard is that block flattened and cut into equal
    runs over ``axes`` (joint row-major order), so gathering over ``axes``
    gives the block back.  The model axes of ``cut`` and ``axes`` together
    are ``param_pspec_fsdp``'s, which sets the bytes: a rank holds the
    leaf's size over their size, as the reference's does.  A stacked leaf
    whose period does not
    cut into equal runs (hymba's (periods, 25) per-head leaves) is cut
    whole, and gathered whole for each of its periods."""
    shape: Tuple[int, ...]
    block: Tuple[int, ...]
    cut: Optional[tuple]
    axes: Tuple[str, ...]
    per_period: bool


def fsdp_leaf(name: str, leaf, mesh: Mesh, tp: bool) -> FsdpLeaf:
    """The :class:`FsdpLeaf` of the leaf at ``name`` (its "/"-joined path);
    ``tp``: the layers compute tensor-parallel on model-axis blocks."""
    shape = tuple(leaf.shape)
    spec = param_pspec_fsdp(name, leaf, mesh)
    group = tuple(a for e in spec for a in _axes_of(e))
    cut = None
    model = model_axes_of(mesh)
    if tp and _axes_size(mesh, model) > 1:
        dim = _tp_dim(tuple(name.split("/")), len(shape))
        m = _axes_size(mesh, model)
        if dim is not None and shape[dim] % m == 0 and shape[dim] >= m:
            cut = (dim, model)
    block = list(shape)
    axes = group
    if cut is not None:
        block[cut[0]] //= m
        if not set(model) <= set(group):
            raise ValueError(f"{name}: FSDP spec {spec} leaves the model "
                             f"axes of its tensor-parallel cut whole")
        axes = tuple(a for a in group if a not in model)
    runs = _axes_size(mesh, axes)
    per_period = (name.startswith(STACKED_PARAMS) and len(shape) > 1
                  and math.prod(block[1:]) % runs == 0)
    if per_period:
        block = block[1:]
    if math.prod(block) % runs:
        raise ValueError(f"{name}: a block of {tuple(block)} does not cut "
                         f"into {runs} equal runs")
    return FsdpLeaf(shape, tuple(block), cut, axes, per_period)


class FsdpLayout:
    """The FSDP layout of a model's params on a world ``mesh`` (a
    ``HostMesh``; a :class:`Mesh` description serves for the plans and
    :meth:`shard_bytes`): every leaf's :class:`FsdpLeaf`, by path.
    :meth:`shard` cuts whole trees (params, or an optimizer state's
    params-shaped trees) to this rank's shards, :meth:`gather` gathers
    shards into the blocks the layers compute on (differentiably: the
    gradient is summed
    over ``rows``, the ``data`` axis that a worker's batch rows are cut
    over, and cut back to the shard), :meth:`join` rebuilds whole
    leaves."""

    def __init__(self, full, mesh, tp: bool):
        self.mesh = mesh
        self.rows = ("data",) if "data" in mesh.axis_names else ()
        self.plans, self.itemsize = {}, {}

        def plan(path, leaf):
            name = "/".join(path)
            self.plans[name] = fsdp_leaf(name, leaf, mesh, tp)
            self.itemsize[name] = leaf.dtype.itemsize

        _map_with_path(plan, full)

    def _plan(self, prefix: str, path) -> FsdpLeaf:
        return self.plans["/".join(([prefix] if prefix else []) + list(path))]

    def _map(self, fn, tree, prefix: str):
        return _map_with_path(lambda path, x: fn(self._plan(prefix, path), x),
                              tree)

    def shard_of(self, plan: FsdpLeaf, x):
        """This rank's shard of the whole leaf ``x`` (a copy)."""
        if plan.cut is not None:
            dim, names = plan.cut
            size = x.shape[dim] // _axes_size(self.mesh, names)
            x = x.narrow(dim, block_index(self.mesh, names) * size, size)
        runs = _axes_size(self.mesh, plan.axes)
        i = block_index(self.mesh, plan.axes) if plan.axes else 0
        lead = (x.shape[0],) if plan.per_period else ()
        flat = x.reshape(lead + (-1,))
        n = flat.shape[-1] // runs
        return flat.narrow(-1, i * n, n).clone()

    def shard(self, tree):
        """This rank's shards of a whole params-shaped tree; an optimizer
        state's ``step`` passes."""
        if isinstance(tree, dict) and "step" in tree:
            return {k: (v if k == "step" else self.shard(v))
                    for k, v in tree.items()}
        return self._map(self.shard_of, tree, "")

    def period(self, tree, prefix: str, i: int):
        """Period ``i`` of the shards of a stacked subtree at ``prefix``:
        a per-period leaf's row, a leaf cut whole as it is."""
        return self._map(lambda plan, x: x[i] if plan.per_period else x,
                         tree, prefix)

    def gather(self, tree, prefix: str = "", period: Optional[int] = None):
        """The blocks of the shards in ``tree`` (the subtree at
        ``prefix``; of period ``period`` of a stacked one, from
        :meth:`period`), gathered with one collective for the leaves
        that the same ranks hold alike (``dist/collectives.py::
        fsdp_gather``; one for each dtype)."""
        from repro_torch import tree as tree_util
        from repro_torch.dist.collectives import fsdp_gather
        names = _leaf_paths(tree)
        xs = tree_util.leaves(tree)
        plans = [self._plan(prefix, path) for path in names]
        groups: dict = {}
        for j, plan in enumerate(plans):
            groups.setdefault((plan.axes, xs[j].dtype), []).append(j)
        out = [None] * len(xs)
        rows = self.mesh.axes(self.rows)
        for (axes, _), js in groups.items():
            got = fsdp_gather([xs[j] for j in js], self.mesh.axes(axes),
                              rows, [plans[j].block for j in js])
            for j, g in zip(js, got):
                whole_stack = period is not None and not plans[j].per_period
                out[j] = g[period] if whole_stack else g
        return tree_util.unflatten(tree, out)

    def join(self, tree):
        """Whole leaves from every rank's shards (collectives); an
        optimizer state's ``step`` passes."""
        from repro_torch.dist.collectives import all_gather_axes
        if isinstance(tree, dict) and "step" in tree:
            return {k: (v if k == "step" else self.join(v))
                    for k, v in tree.items()}

        def one(plan, x):
            lead = x.shape[:1] if plan.per_period else ()
            b = all_gather_axes(x.contiguous(), self.mesh.axes(plan.axes),
                                len(lead))
            shape = lead + plan.block if plan.per_period else plan.block
            b = b.reshape(shape)
            if plan.cut is not None:
                b = all_gather_axes(b, self.mesh.axes(plan.cut[1]),
                                    plan.cut[0])
            return b.reshape(plan.shape)

        return self._map(one, tree, "")

    def salt(self, plan: FsdpLeaf) -> int:
        """This rank's shard's index among the leaf's distinct shards:
        ranks that hold the same shard share it."""
        names = (plan.cut[1] if plan.cut else ()) + plan.axes
        order = tuple(a for a in self.mesh.axis_names if a in names)
        return block_index(self.mesh, order) if order else 0

    def counts(self, plan: FsdpLeaf) -> bool:
        """Whether this rank is the one of a shard's holders that counts
        it in a sum over the world (the first on the other axes)."""
        names = set(plan.axes) | set(plan.cut[1] if plan.cut else ())
        return all(c == 0 for a, c in zip(self.mesh.axis_names,
                                          self.mesh.coords)
                   if a not in names)

    def shard_bytes(self) -> int:
        """A rank's bytes of the params' shards (``param_pspec_fsdp``'s:
        each leaf's size over the size of its spec's axes)."""
        return sum(math.prod(p.block) // _axes_size(self.mesh, p.axes)
                   * (p.shape[0] if p.per_period else 1) * self.itemsize[n]
                   for n, p in self.plans.items())

    def leaf_plans(self, tree) -> list:
        """The :class:`FsdpLeaf` of each leaf of a params-shaped ``tree``,
        in ``repro_torch.tree.leaves`` order."""
        return [self._plan("", path) for path in _leaf_paths(tree)]


def _leaf_paths(tree, path=()):
    """Each leaf's path, in ``repro_torch.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, path + (str(i),))]
    return [path]


# ---------------------------------------------------------------------------
# Cutting trees to this rank's blocks
# ---------------------------------------------------------------------------

def block_index(mesh: Mesh, names: Sequence[str]) -> int:
    """This rank's joint (row-major) coordinate on the axes ``names`` of a
    world mesh (one with ``coords``)."""
    idx = 0
    for n in names:
        i = mesh.axis_names.index(n)
        idx = idx * mesh.axis_sizes[i] + mesh.coords[i]
    return idx


def block_shape(shape: Sequence[int], spec: P, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one block of a leaf of ``shape`` cut by ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            out[dim] //= _axes_size(mesh, names)
    return tuple(out)


def cut_leaf(x, spec: P, mesh: Mesh):
    """This rank's block of ``x`` by ``spec``, a copy (so that the whole can
    be freed); ``x`` itself when ``spec`` replicates it."""
    if all(e is None for e in spec):
        return x
    for dim, entry in enumerate(spec):
        if entry is not None:
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            size = x.shape[dim] // _axes_size(mesh, names)
            x = x.narrow(dim, block_index(mesh, names) * size, size)
    return x.clone()


def shard_params(params, mesh: Mesh, full=None):
    """This rank's blocks of ``params`` by :func:`tree_pspecs` of ``full``
    (a tree of the whole leaves' shapes, such as
    ``Model.abstract_params()``; by default ``params``).  A leaf that is
    already its block passes as it is; a leaf with no shape (the
    optimizer's step count) too."""
    full = params if full is None else full
    specs = spec_leaves(tree_pspecs(full, mesh))
    from repro_torch import tree as tree_util
    out = []
    for x, f, spec in zip(tree_util.leaves(params), tree_util.leaves(full),
                          specs):
        if not hasattr(x, "shape") or tuple(x.shape) != tuple(f.shape):
            want = block_shape(f.shape, spec, mesh)
            if hasattr(x, "shape") and tuple(x.shape) != want:
                raise ValueError(f"a leaf of shape {tuple(x.shape)} is "
                                 f"neither the whole {tuple(f.shape)} nor "
                                 f"its block {want}")
            out.append(x)
        else:
            out.append(cut_leaf(x, spec, mesh))
    return tree_util.unflatten(params, out)


def shard_cache(cache, mesh: Mesh):
    """This rank's blocks of a whole KV cache by :func:`cache_pspec`."""
    return _map_with_path(
        lambda path, leaf: cut_leaf(leaf, cache_pspec(path, leaf, mesh),
                                    mesh), cache)


def init_blocks(model, seed: int, mesh: Mesh, device):
    """This rank's blocks of ``model.init`` from a generator on ``device``
    seeded with ``seed``: the ranks of the world take turns to draw the
    whole model, cut their blocks and free the rest, with a barrier
    between turns, so one whole model at most exists at a time."""
    import torch
    import torch.distributed as dist
    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gen = torch.Generator(device=device).manual_seed(seed)
            out = shard_params(model.init(gen), mesh)
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return out


# ---------------------------------------------------------------------------
# KV-cache rule
# ---------------------------------------------------------------------------

def heads_split(num_heads: int, tp: int) -> bool:
    """Whether ``tp`` > 1 model ranks each take whole heads of
    ``num_heads``: the rule :func:`cache_pspec` cuts a K/V cache's heads
    by, and by which a GQA layer attends on this rank's K/V heads
    (``models/common.py::heads_local``)."""
    return tp > 1 and num_heads % tp == 0


# Cache subtrees stacked on a leading layer dim: the decoder stack's
# period-scanned ``blocks`` and whisper's per-layer ``self`` and ``cross``
# K/V ((L, B, T, Kv, hd), ``models/encdec.py::init_cache``).
_STACKED_CACHES = frozenset({"blocks", "self", "cross"})


def cache_pspec(path: Sequence[str], leaf, mesh: Mesh) -> P:
    """Partition spec of one KV-cache leaf at ``path`` (its dict keys).

    Caches are batch-major (attention ``k``/``v``: (B, T, Kv, hd); MLA
    latents: (B, T, rank); Mamba states: (B, ...)), except under a
    layer-stacked subtree (``_STACKED_CACHES``), which prepends a leading
    layer or period dim.  The request batch shards over the worker axes
    and GQA KV heads over the model axes when they divide; so do the heads
    of a Mamba2 SSM state ``ssm`` ((B, H, P, N)), which the head-parallel
    block keeps this rank's of (``models/ssm.py``).

    Two cuts are the port's own, a layout with the reference's values:
    the reference shifts the batch dim only under ``blocks`` (under GSPMD
    its spec on whisper's layer dim is harmless; cutting that dim would
    not be), and it leaves the SSM state's heads whole.
    """
    names = tuple(str(n) for n in path)
    shape = tuple(leaf.shape)
    offset = 1 if names and names[0] in _STACKED_CACHES else 0
    spec = [None] * len(shape)
    wa = worker_axes_of(mesh)
    m = _axes_size(mesh, wa)
    if m > 1 and len(shape) > offset and shape[offset] % m == 0:
        spec[offset] = wa if len(wa) > 1 else wa[0]
    model_axes = model_axes_of(mesh)
    tp = _axes_size(mesh, model_axes)
    head_dim = {"k": offset + 2, "v": offset + 2, "ssm": offset + 1}.get(
        names[-1] if names else "")
    if (head_dim is not None and len(shape) == offset + 4
            and heads_split(shape[head_dim], tp)):
        spec[head_dim] = model_axes if len(model_axes) > 1 else model_axes[0]
    return P(*spec)
