"""Public entry points of the kernels, the rules' and the models' only way to
them (the reference's ``kernels/{trmean,phocas,krum,flashattn}/ops.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.aggregators import krum_scores_from_d2, lowest_scores
from repro_torch.kernels.flashattn.kernel import flash_attention_hopper
from repro_torch.kernels.krum.kernel import pairwise_sq_dists_hopper

from repro_torch.kernels.phocas.kernel import (phocas_counts_hopper,
                                               phocas_hopper)
from repro_torch.kernels.trmean.kernel import (trmean_counts_hopper,
                                               trmean_hopper)


def _mean_and_no_counts(u: torch.Tensor):
    return u.float().mean(dim=0), torch.zeros(
        (u.shape[0],), dtype=torch.float32, device=u.device)


def trmean(u: torch.Tensor, b: int) -> torch.Tensor:
    """Coordinate-wise b-trimmed mean; (m, d) -> (d,) f32.

    b = 0 is the plain mean, as in the reference's ``ops.py``.
    """
    if b == 0:
        return u.float().mean(dim=0)
    return trmean_hopper(u, b)


def phocas(u: torch.Tensor, b: int) -> torch.Tensor:
    """Phocas aggregation; (m, d) -> (d,) f32.

    b = 0 is the plain mean, as in the reference's ``ops.py``.
    """
    if b == 0:
        return u.float().mean(dim=0)
    return phocas_hopper(u, b)


def trmean_with_counts(u: torch.Tensor, b: int):
    """Trimmed mean AND per-worker drop counts; (m, d) -> ((d,), (m,)) f32.

    The counts are the defense's suspicion statistic.  b = 0 is the plain
    mean with zero counts, as in the reference's ``ops.py``.
    """
    if b == 0:
        return _mean_and_no_counts(u)
    return trmean_counts_hopper(u, b)


def phocas_with_counts(u: torch.Tensor, b: int):
    """Phocas aggregate AND per-worker drop counts; (m, d) -> ((d,), (m,))
    f32.  b = 0 is the plain mean with zero counts, as in the reference's
    ``ops.py``."""
    if b == 0:
        return _mean_and_no_counts(u)
    return phocas_counts_hopper(u, b)


def pairwise_sq_dists(u: torch.Tensor) -> torch.Tensor:
    """(m, d) -> (m, m) f32 squared distances from the Krum Gram kernel."""
    return pairwise_sq_dists_hopper(u)


def krum(u: torch.Tensor, q: int) -> torch.Tensor:
    """(m, d) -> (d,) f32: the candidate with minimal Krum score
    (Definition 3), its distances from the Gram kernel."""
    scores = krum_scores_from_d2(pairwise_sq_dists(u), q)
    return u[torch.argmin(scores)].float()


def multikrum(u: torch.Tensor, q: int, k: Optional[int] = None
              ) -> torch.Tensor:
    """(m, d) -> (d,) f32: the mean of the k lowest-score candidates
    (k = m - q - 2 by default), distances from the Gram kernel."""
    if k is None:
        k = u.shape[0] - q - 2
    scores = krum_scores_from_d2(pairwise_sq_dists(u), q)
    return u.float()[lowest_scores(scores, k)].mean(dim=0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,Kv,hd) -> (B,S,H,hd) in q's dtype, through
    the flash-attention kernel.  Unlike the reference's ``ops.py`` nothing is
    padded: the kernel masks ragged S and T itself."""
    return flash_attention_hopper(q, k, v, causal=causal, window=window,
                                  cap=cap, scale=scale)
