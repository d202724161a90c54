"""Tree checkpointing: flattened-path ``.npz`` + a JSON manifest.

Port of ``repro/checkpoint/io.py`` with the same on-disk format, so the
``params``/``opt`` leaves of a checkpoint written by either package load in
the other:

* ``<path>.npz`` holds one array per leaf under its ``/``-joined tree path
  (dict keys sorted, as ``jax.tree_util`` flattens them); bfloat16 is stored
  as its uint16 bit pattern and Python ints (the optimizer's step, the
  rule's b/q) as int32, as the reference's 0-d int32 arrays;
* ``<path>.json`` records the step, every leaf's dtype and a sha256 of the
  payload.

``save_checkpoint`` is atomic: both files are written to temporaries, the
previous checkpoint is rotated to ``<path>.prev.*``, then the new files are
moved into place with ``os.replace``, so a kill at any instant leaves at
least one loadable checkpoint.  ``restore_checkpoint`` falls back to the
``.prev`` pair when the newest one is missing, truncated or fails its
checksum (:class:`CheckpointError`).

The one difference from the reference: its ``key`` leaf is a JAX PRNG key,
and the port's is the state of its ``torch.Generator``
(``Generator.get_state()``, a uint8 tensor).  The port's manifest says so
(``extra["rng"] = "torch.Generator"``), and :func:`restore_checkpoint` loads
the subtrees named in ``port_only`` from such a checkpoint only: a
reference checkpoint restores params, optimizer and the rest, and leaves the
generator as it is.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

RNG_TAG = "torch.Generator"


class CheckpointError(RuntimeError):
    """A checkpoint is missing, truncated, or fails its checksum."""


def _flatten_with_paths(tree, prefix=()):
    """(path tuple, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flatten_with_paths(t, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    return {"/".join(p): leaf for p, leaf in _flatten_with_paths(tree)}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """A stored array in the type of ``like``: a Python int for an int leaf,
    else a tensor of the stored dtype on ``like``'s device."""
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    device = like.device if isinstance(like, torch.Tensor) else None
    return t if device is None else t.to(device)


def _paths(path: str) -> Tuple[str, str]:
    return path + ".npz", path + ".json"


def save_checkpoint(path: str, tree: Any, *, step: int = 0) -> None:
    """Atomically write ``tree`` to ``<path>.npz`` + ``<path>.json``,
    rotating an existing checkpoint at ``path`` to ``<path>.prev.*``
    first."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    meta = {"step": int(step), "dtypes": {}, "keys": [],
            "extra": {"rng": RNG_TAG}}
    for k, v in _flatten(tree).items():
        arrays[k], meta["dtypes"][k] = _to_numpy(v)
        meta["keys"].append(k)
    npz, man = _paths(path)
    tmp_npz, tmp_man = npz + ".tmp", man + ".tmp"
    with open(tmp_npz, "wb") as f:
        np.savez(f, **arrays)
    with open(tmp_npz, "rb") as f:
        meta["sha256"] = hashlib.sha256(f.read()).hexdigest()
    with open(tmp_man, "w") as f:
        json.dump(meta, f)
    # Rotate old -> .prev before the new files land: every interleaving of
    # a crash with these renames leaves a complete (npz, json) pair.
    prev_npz, prev_man = _paths(path + ".prev")
    if os.path.exists(npz) and os.path.exists(man):
        os.replace(npz, prev_npz)
        os.replace(man, prev_man)
    os.replace(tmp_npz, npz)
    os.replace(tmp_man, man)


def _load(path: str, like: Any, optional: Sequence[str],
          port_only: Sequence[str]):
    npz, man = _paths(path)
    try:
        with open(man) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"checkpoint manifest {man}: {e}") from None
    if "sha256" in meta:
        try:
            with open(npz, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
        except OSError as e:
            raise CheckpointError(f"checkpoint payload {npz}: {e}") from None
        if digest != meta["sha256"]:
            raise CheckpointError(
                f"checkpoint {path} failed its checksum (manifest says "
                f"{meta['sha256'][:12]}..., payload hashes to "
                f"{digest[:12]}...); the file is corrupt or half-written")
    try:
        data = np.load(npz)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"checkpoint payload {npz}: {e}") from None
    ours = meta.get("extra", {}).get("rng") == RNG_TAG
    out = []
    for k, v in _flatten(like).items():
        top = k.split("/", 1)[0]
        if k not in data or (top in port_only and not ours):
            if top in optional:
                out.append(v)             # keep like's current value
                continue
            raise CheckpointError(
                f"checkpoint {path} lacks key {k!r} required by the "
                "restore target")
        out.append(_from_numpy(data[k], meta["dtypes"][k], v))
    return tree_util.unflatten(like, out), meta["step"]


def load_checkpoint(path: str, like: Any):
    """Restore into the structure of ``like`` (a tree of tensors and ints).
    Returns ``(tree, step)``; raises :class:`CheckpointError` on a missing,
    truncated or corrupt file."""
    return _load(path, like, (), ())


def restore_checkpoint(path: str, like: Any, optional: Sequence[str] = (),
                       port_only: Sequence[str] = ()):
    """Load ``path``, falling back to its rotated ``.prev`` checkpoint when
    the newest one is corrupt or missing.

    ``optional`` names top-level subtrees of ``like`` that a checkpoint may
    lack (they keep their value in ``like``); ``port_only`` those read only
    from a checkpoint this package wrote (the generator state).  Returns
    ``(tree, step, used_fallback)``.
    """
    last_err = None
    for candidate, is_prev in ((path, False), (path + ".prev", True)):
        try:
            tree, step = _load(candidate, like, tuple(optional),
                               tuple(port_only))
            return tree, step, is_prev
        except CheckpointError as e:
            last_err = e
    raise CheckpointError(
        f"no valid checkpoint at {path} (nor its .prev fallback): "
        f"{last_err}")
