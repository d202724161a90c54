"""repro_torch's CUDA kernels on the card (marked ``cuda``; skip without one).

No JAX here, so the file runs where only PyTorch is installed.  Run with
``python -m pytest -q -m cuda --noconftest -p no:cacheprovider
tests/test_torch_cuda.py`` (``--noconftest`` because ``tests/conftest.py``
imports JAX).  Each kernel divides as PyTorch's CUDA division by a scalar
does, so it equals its plain version bit for bit, adversarial rows included;
the counts kernels' drop counts equal their plain versions' as integers.
The Krum Gram kernel sums its products in another order than the plain
version's ``torch.mm`` (TF32 off), so it is held at the reference's bound for
the Gram form, atol 1e-6 * max + 1e-3, with NaN and inf at the same places,
and the exceptions ``chip_smoke.py::compare_gram`` states.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.registry import RuleParams, make_rule
from repro_torch.kernels.krum.kernel import pairwise_sq_dists_hopper
from repro_torch.kernels.krum.ref import pairwise_sq_dists_ref
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
    torch.backends.cuda.matmul.allow_tf32 = False
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


def _assert_gram_close(u, got, want):
    """The bound of ``chip_smoke.py::compare_gram``: its max over the
    distances and the finite n_i + n_j (the Gram form's rounding scales with
    the squared norms), and a kernel diagonal of exactly 0 on finite rows."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    fin_diag = torch.isfinite(torch.diagonal(want))
    assert (torch.diagonal(got)[fin_diag] == 0).all()
    off = ~torch.eye(got.shape[0], dtype=torch.bool, device=got.device)
    fin = torch.isfinite(want) & off
    if fin.any():
        sq = (u.float() * u.float()).sum(dim=1)
        pair = sq[:, None] + sq[None, :]
        scale = max(want[fin].abs().max().item(),
                    pair[torch.isfinite(pair) & fin].abs().max().item())
        assert (got[fin] - want[fin]).abs().max().item() <= 1e-6 * scale + 1e-3
    # one value per pair: exactly symmetric
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(got.T))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 5, 20, 31, 32, 33, 64, 100])
def test_gram_kernel_equals_plain_version(cuda, m):
    for name, u in _matrices(m, 3001, cuda).items():
        for x in (10.0 * u, u.to(torch.bfloat16), u.to(torch.float16)):
            if name == "big" and x.dtype != torch.float32:
                continue
            n = pairwise_sq_dists_hopper.launches
            got = pairwise_sq_dists_hopper(x)
            torch.cuda.synchronize()
            assert pairwise_sq_dists_hopper.launches == n + 1
            _assert_gram_close(x, got, pairwise_sq_dists_ref(x))
            again = pairwise_sq_dists_hopper(x)         # bitwise repeatable
            assert torch.equal(again.view(torch.int32),
                               got.view(torch.int32)), name


@pytest.mark.cuda
def test_gram_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_sq_dists_hopper(torch.zeros((16, 8), device=cuda).t())
    with pytest.raises(ValueError, match="dtype|take"):
        pairwise_sq_dists_hopper(torch.zeros((4, 8), dtype=torch.float64,
                                             device=cuda))
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        pairwise_sq_dists_hopper(torch.zeros((4, 8, 2), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["krum", "multikrum"])
def test_auto_backend_launches_the_gram_kernel_on_cuda(cuda, rule):
    """One Gram launch per aggregation, plain or defended; the plain
    backend picks the same workers."""
    u = _matrices(20, 777, cuda)["gauss"].reshape(20, 7, 111).clone()
    u[:4] *= -5.0
    kernel_rule = make_rule(rule, RuleParams(q=4, backend="auto"))
    plain_rule = make_rule(rule, RuleParams(q=4, backend="xla"))
    n = pairwise_sq_dists_hopper.launches
    got = kernel_rule.reduce(u)
    assert pairwise_sq_dists_hopper.launches == n + 1
    assert got.shape == (7, 111)
    torch.testing.assert_close(got, plain_rule.reduce(u), rtol=0, atol=1e-5)
    assert pairwise_sq_dists_hopper.launches == n + 1
    for active in (None, torch.ones(20, device=cuda),
                   torch.tensor([0.0] * 3 + [1.0] * 17, device=cuda)):
        n = pairwise_sq_dists_hopper.launches
        agg, scores = kernel_rule.reduce_gated_with_scores(u, active)
        assert pairwise_sq_dists_hopper.launches == n + 1
        want_agg, want_scores = plain_rule.reduce_gated_with_scores(u, active)
        torch.testing.assert_close(agg, want_agg, rtol=0, atol=1e-5)
        torch.testing.assert_close(scores, want_scores, rtol=0, atol=1e-4)
