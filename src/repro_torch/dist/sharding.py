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
# KV-cache rule
# ---------------------------------------------------------------------------

def cache_pspec(path: Sequence[str], leaf, mesh: Mesh) -> P:
    """Partition spec of one KV-cache leaf at ``path`` (its dict keys).

    Caches are batch-major (attention ``k``/``v``: (B, T, Kv, hd); MLA
    latents: (B, T, rank); Mamba states: (B, ...)), except under the
    period-scanned ``blocks`` subtree, which prepends an (n_periods,) dim.
    The request batch shards over the worker axes and GQA KV heads over the
    model axes when they divide.
    """
    names = tuple(str(n) for n in path)
    shape = tuple(leaf.shape)
    offset = 1 if names and names[0] == "blocks" else 0
    spec = [None] * len(shape)
    wa = worker_axes_of(mesh)
    m = _axes_size(mesh, wa)
    if m > 1 and len(shape) > offset and shape[offset] % m == 0:
        spec[offset] = wa if len(wa) > 1 else wa[0]
    model_axes = model_axes_of(mesh)
    tp = _axes_size(mesh, model_axes)
    head_dim = offset + 2
    if (tp > 1 and names and names[-1] in ("k", "v")
            and len(shape) == offset + 4 and shape[head_dim] % tp == 0):
        spec[head_dim] = model_axes if len(model_axes) > 1 else model_axes[0]
    return P(*spec)
