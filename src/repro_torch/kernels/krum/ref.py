"""Plain PyTorch version of the Krum Gram kernel K5: the function the kernel
computes, in f32, in the Gram form of the reference's XLA path."""
from __future__ import annotations

import torch


def pairwise_sq_dists_ref(u: torch.Tensor) -> torch.Tensor:
    """(m, d) -> (m, m) f32 squared distances max(n_i + n_j - 2 G_ij, 0),
    with the reference's norms n_i = sum(u_i * u_i).

    ``torch.clamp(min=0)`` keeps NaN, as ``jnp.maximum`` does: two rows at
    +-1e20 of one sign meet as inf - inf.  Run on the card with TF32 off, as
    the reference's f32 product is.  The diagonal is n_i + n_i - 2 G_ii, the
    difference of two roundings of one sum, so it may be a small positive
    number where the kernel, whose n_i is its own G_ii, gives exactly 0.
    """
    uf = u.float()
    sq = (uf * uf).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (uf @ uf.T)
    return torch.clamp(d2, min=0.0)
