"""Parameter trees and defense states between the reference (as numpy) and
this package.

The port stores parameters in the reference's layout (fc ``w`` as
(din, dout), conv ``w`` as HWIO), so conversion is a copy of each leaf with
the same shape, in either direction.  Nothing here imports JAX: pass the
reference's tree through ``numpy.asarray`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_util


def params_from_numpy(tree, device=None):
    """Nested dict of arrays -> nested dict of f32 tensors on ``device``."""
    return tree_util.map(
        lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                               device=device), tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return tree_util.map(lambda x: x.detach().cpu().numpy(), tree)


# Parameters the reference holds in f32 whatever the model's dtype: the MoE
# router (``repro/models/moe.py::init_moe``) and the Mamba2 block's
# ``dt_bias``, ``A_log`` and ``D`` (``repro/models/ssm.py::init_mamba``).
F32_PARAMS = ("router", "dt_bias", "A_log", "D")


def lm_params_from_numpy(tree, device=None, dtype=None):
    """An LM parameter tree (nested dict of arrays, the reference's
    ``lm.init`` layout) -> the same keys and shapes as tensors on
    ``device``, in ``dtype`` (default: each array's own float dtype; pass
    ``torch.bfloat16`` for the reference's bf16 leaves, which numpy holds as
    float32 or ml_dtypes).  Leaves under an ``F32_PARAMS`` key stay f32, as
    in the reference."""
    def one(x, keep_f32):
        arr = np.asarray(x)
        if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
            arr = arr.astype(np.float32)
        t = torch.tensor(arr, device=device)
        if keep_f32:
            return t.float()
        return t if dtype is None else t.to(dtype)

    def walk(t, keep_f32=False):
        if isinstance(t, dict):
            return {k: walk(v, keep_f32 or k in F32_PARAMS)
                    for k, v in t.items()}
        return one(t, keep_f32)
    return walk(tree)


def lm_params_to_numpy(tree):
    """An LM parameter tree of tensors -> nested dict of f32 numpy arrays."""
    return tree_util.map(lambda x: x.detach().float().cpu().numpy(), tree)


def defense_state_from_numpy(state: dict, device=None) -> dict:
    """Reputation state (dict of arrays) -> dict of tensors on ``device``.

    ``steps`` stays int32 (``params_from_numpy`` would cast it to f32); the
    per-worker vectors become f32."""
    return {k: torch.tensor(np.asarray(v),
                            dtype=torch.int32 if k == "steps"
                            else torch.float32, device=device)
            for k, v in state.items()}


def defense_state_to_numpy(state: dict) -> dict:
    """Reputation state (dict of tensors) -> dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
