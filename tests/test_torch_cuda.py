"""repro_torch's CUDA kernels on the card (marked ``cuda``; skip without one).

No JAX here, so the file runs where only PyTorch is installed.  Run with
``python -m pytest -q -m cuda --noconftest -p no:cacheprovider
tests/test_torch_cuda.py`` (``--noconftest`` because ``tests/conftest.py``
imports JAX).  Each kernel divides as PyTorch's CUDA division by a scalar
does, so it equals its plain version bit for bit, adversarial rows included.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.registry import RuleParams, make_rule
from repro_torch.kernels.phocas.kernel import phocas_hopper
from repro_torch.kernels.phocas.ref import phocas_ref
from repro_torch.kernels.trmean.kernel import trmean_hopper
from repro_torch.kernels.trmean.ref import trmean_ref

PAIRS = ((trmean_hopper, trmean_ref), (phocas_hopper, phocas_ref))


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
