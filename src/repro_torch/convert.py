"""Parameter trees between the reference (as numpy) and this package.

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
