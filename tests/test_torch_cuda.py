"""repro_torch's CUDA kernels on the card (marked ``cuda``; skip without one).

No JAX here, so the file runs where only PyTorch is installed.  Run with
``python -m pytest -q -m cuda --noconftest -p no:cacheprovider
tests/test_torch_cuda.py`` (``--noconftest`` because ``tests/conftest.py``
imports JAX).  Each kernel divides as PyTorch's CUDA division by a scalar
does, so it equals its plain version bit for bit, adversarial rows included;
the counts kernels' drop counts equal their plain versions' as integers.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.registry import RuleParams, make_rule
from repro_torch.kernels.phocas.kernel import (phocas_counts_hopper,
                                               phocas_hopper)
from repro_torch.kernels.phocas.ref import phocas_counts_ref, phocas_ref
from repro_torch.kernels.trmean.kernel import (trmean_counts_hopper,
                                               trmean_hopper)
from repro_torch.kernels.trmean.ref import trmean_counts_ref, trmean_ref

PAIRS = ((trmean_hopper, trmean_ref), (phocas_hopper, phocas_ref))
COUNTS_PAIRS = ((trmean_counts_hopper, trmean_counts_ref),
                (phocas_counts_hopper, phocas_counts_ref))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _matrices(m, d, device):
    rng = np.random.default_rng(m)
    base = (3.0 + rng.standard_normal((m, d))).astype(np.float32)
    dups = np.round(2.0 * base) / 2.0
    big = base.copy()
    big[m // 2, ::3] = -1e20
    big[m // 3, 1::5] = 1e20
    nonfinite = base.copy()
    nonfinite[0, ::4] = np.nan
    nonfinite[m - 1, 1::4] = np.inf
    nonfinite[m // 2, 2::4] = -np.inf
    return {k: torch.tensor(v, device=device) for k, v in
            dict(gauss=base, dups=dups, big=big, nonfinite=nonfinite).items()}


def _assert_same(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 16, 20, 33, 64])
def test_kernels_equal_plain_versions(cuda, m):
    for name, u in _matrices(m, 3001, cuda).items():
        for b in range((m + 1) // 2):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                x = u.to(dtype) if name != "big" else u
                for kernel, ref in PAIRS:
                    n = kernel.launches
                    got = kernel(x, b)
                    torch.cuda.synchronize()
                    assert kernel.launches == n + 1
                    _assert_same(got, ref(x, b))


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    u = torch.zeros((8, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        trmean_hopper(u.t().contiguous().t(), 2)
    with pytest.raises(ValueError, match="m <= 64"):
        phocas_hopper(torch.zeros((65, 16), device=cuda), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["trmean", "phocas"])
def test_auto_backend_launches_the_kernel_on_cuda(cuda, rule):
    u = _matrices(20, 777, cuda)["gauss"].reshape(20, 7, 111)
    kernel = trmean_hopper if rule == "trmean" else phocas_hopper
    n = kernel.launches
    got = make_rule(rule, RuleParams(b=6, backend="auto")).reduce(u)
    assert kernel.launches == n + 1 and got.shape == (7, 111)
    plain = make_rule(rule, RuleParams(b=6, backend="xla")).reduce(u)
    assert kernel.launches == n + 1
    _assert_same(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("m", range(1, 65))
def test_counts_kernels_equal_plain_versions(cuda, m):
    bmax = (m + 1) // 2 - 1
    bs = sorted({0, 1, bmax // 2, bmax} & set(range(bmax + 1)))
    for name, u in _matrices(m, 3001, cuda).items():
        for b in bs:
            dtypes = (torch.float32, torch.bfloat16, torch.float16) \
                if name == "gauss" else (torch.float32,)
            for dtype in dtypes:
                x = u.to(dtype)
                for kernel, ref in COUNTS_PAIRS:
                    n = kernel.launches
                    agg, counts = kernel(x, b)
                    torch.cuda.synchronize()
                    assert kernel.launches == n + 1
                    want_agg, want_counts = ref(x, b)
                    _assert_same(agg, want_agg)
                    assert counts.dtype == torch.float32
                    assert torch.equal(counts, want_counts), (name, b)
                    assert int(counts.sum()) <= 2 * b * x.shape[1]


@pytest.mark.cuda
def test_counts_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="m <= 64"):
        phocas_counts_hopper(torch.zeros((65, 16), device=cuda), 2)
    with pytest.raises(ValueError, match="m <= 64"):
        trmean_counts_hopper(torch.zeros((65, 16), device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        trmean_counts_hopper(torch.zeros((16, 8), device=cuda).t(), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["trmean", "phocas"])
def test_defended_aggregation_launches_the_kernels_on_cuda(cuda, rule):
    """One counts launch per defended aggregation; the aggregate kernel runs
    again only once a worker is ejected; the plain backend agrees."""
    u = _matrices(20, 777, cuda)["gauss"].reshape(20, 7, 111)
    counts_k = trmean_counts_hopper if rule == "trmean" else \
        phocas_counts_hopper
    agg_k = trmean_hopper if rule == "trmean" else phocas_hopper
    kernel_rule = make_rule(rule, RuleParams(b=6, backend="auto"))
    plain_rule = make_rule(rule, RuleParams(b=6, backend="xla"))
    for active in (torch.ones(20, device=cuda),
                   torch.tensor([0.0] * 3 + [1.0] * 17, device=cuda)):
        n_counts, n_agg = counts_k.launches, agg_k.launches
        agg, scores = kernel_rule.reduce_gated_with_scores(u, active)
        ejected = int((active == 0).sum()) > 0
        assert counts_k.launches == n_counts + 1
        assert agg_k.launches == n_agg + int(ejected)
        want_agg, want_scores = plain_rule.reduce_gated_with_scores(u, active)
        _assert_same(agg, want_agg)
        assert torch.equal(scores, want_scores)
