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
and the exceptions ``chip_smoke.py::compare_gram`` states.  The
flash-attention kernel is held to its plain version at the reference's
tolerances (``tests/test_flashattn.py``): 2e-3 in f32, 3e-2 in bf16 and f16,
and must repeat bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.registry import RuleParams, make_rule
from repro_torch.kernels import build
from repro_torch.kernels.flashattn.kernel import flash_attention_hopper
from repro_torch.kernels.flashattn.ref import flash_attention_ref
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
# m past the register kernels' 64, where the shared-memory variant runs.
WIDE_MS = [65, 80, 96, 127, 128, 200, 1024]


def _bs(m):
    """Every b up to m = 64; past it 0, 1, the middle and the largest."""
    bmax = (m + 1) // 2 - 1
    if m <= 64:
        return range(bmax + 1)
    return sorted({0, 1, bmax // 2, bmax})


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
@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 16, 20, 33, 64, 65, 80, 128,
                               200, 1024])
def test_kernels_equal_plain_versions(cuda, m):
    for name, u in _matrices(m, 3001, cuda).items():
        for b in _bs(m):
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
    cap = build.MAX_M["phocas"]
    with pytest.raises(ValueError, match=f"m <= {cap} workers, got"):
        phocas_hopper(torch.zeros((cap + 1, 16), device=cuda), 2)


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
@pytest.mark.parametrize("m", list(range(1, 65)) + WIDE_MS)
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


def _tie_matrix(m, d, device):
    """Tie-heavy worker matrix: values in {-1, 0, 1}, a constant row block
    and a row of alternating +-inf."""
    rng = np.random.default_rng(1000 + m)
    u = rng.integers(-1, 2, (m, d)).astype(np.float32)
    u[m // 3:m // 3 + max(1, m // 4)] = 0.0
    u[m - 1, ::2] = np.inf
    u[m - 1, 1::2] = -np.inf
    return torch.tensor(u, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("m", list(range(1, 65)) + WIDE_MS)
def test_counts_kernels_equal_plain_versions_on_ties(cuda, m):
    """The b of test_counts_kernels_equal_plain_versions on the tie-heavy
    matrix, where K4's O(m) counts settle most drops by the index walk."""
    bmax = (m + 1) // 2 - 1
    bs = sorted({0, 1, bmax // 2, bmax} & set(range(bmax + 1)))
    u = _tie_matrix(m, 3001, cuda)
    for b in bs:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = u.to(dtype)
            for kernel, ref in COUNTS_PAIRS:
                agg, counts = kernel(x, b)
                torch.cuda.synchronize()
                want_agg, want_counts = ref(x, b)
                _assert_same(agg, want_agg)
                assert torch.equal(counts, want_counts), (b, dtype)


def _four_bs(m):
    """0, 1, m/4 and the largest b, where valid."""
    bmax = (m + 1) // 2 - 1
    return sorted({0, 1, m // 4, bmax} & set(range(bmax + 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("m", list(range(1, 65)))
def test_register_buckets_equal_plain_versions_at_every_m(cuda, m):
    """K1-K4 in the register bucket of every m up to 64 (the pruned
    networks and K1/K3's staged window search), at an odd d whose last
    block is partial, on the adversarial and the tie-heavy matrices:
    aggregates bit for bit, counts equal as integers."""
    d = 4099
    mats = dict(_matrices(m, d, cuda), ties=_tie_matrix(m, d, cuda))
    for name, u in mats.items():
        for b in _four_bs(m):
            for kernel, ref in PAIRS:
                _assert_same(kernel(u, b), ref(u, b))
            for kernel, ref in COUNTS_PAIRS:
                agg, counts = kernel(u, b)
                want_agg, want_counts = ref(u, b)
                _assert_same(agg, want_agg)
                assert torch.equal(counts, want_counts), (name, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [3, 20, 64])
def test_register_kernels_past_one_wave_of_blocks(cuda, m, dtype):
    """K1-K4 at a d larger than the card holds threads, so K1's one-wave
    grid gives every thread more than one column (its prefetched next
    column included) and the last wave is partial: aggregates bit for bit,
    counts equal as integers."""
    d = 400_003
    props = torch.cuda.get_device_properties(cuda)
    assert d > props.multi_processor_count * \
        props.max_threads_per_multi_processor
    mats = dict(_matrices(m, d, cuda), ties=_tie_matrix(m, d, cuda))
    for name, u in mats.items():
        x = u.to(dtype)
        for b in _four_bs(m):
            for kernel, ref in PAIRS:
                n = kernel.launches
                got = kernel(x, b)
                assert kernel.launches == n + 1
                _assert_same(got, ref(x, b))
            for kernel, ref in COUNTS_PAIRS:
                agg, counts = kernel(x, b)
                want_agg, want_counts = ref(x, b)
                _assert_same(agg, want_agg)
                assert torch.equal(counts, want_counts), (name, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [65, 96, 128, 200, 1024, 1025, 2048])
def test_wide_kernels_on_both_sides_of_the_warp_sort_switch(cuda, m):
    """K1/K2 past 64 workers: sorted in one warp's registers up to
    ``build.WARP_SORT_MAX_M`` (1,024) and in shared memory above it; both
    equal the plain versions bit for bit, at a d whose last 32-column tile
    is partial, on the adversarial and the tie-heavy matrices."""
    d = 1031
    mats = dict(_matrices(m, d, cuda), ties=_tie_matrix(m, d, cuda))
    for name, u in mats.items():
        for b in _four_bs(m):
            dtypes = (torch.float32, torch.bfloat16) if name == "gauss" \
                else (torch.float32,)
            for dtype in dtypes:
                x = u.to(dtype)
                for kernel, ref in PAIRS:
                    n = kernel.launches
                    got = kernel(x, b)
                    assert kernel.launches == n + 1
                    _assert_same(got, ref(x, b))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_counts_kernels_reject_what_they_do_not_take(cuda):
    for kernel, name in ((phocas_counts_hopper, "phocas_counts"),
                         (trmean_counts_hopper, "trmean_counts")):
        cap = build.MAX_M[name]
        with pytest.raises(ValueError,
                           match=f"m <= {cap} workers, got m={cap + 1}"):
            kernel(torch.zeros((cap + 1, 16), device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        trmean_counts_hopper(torch.zeros((16, 8), device=cuda).t(), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [20, 96, 200])
@pytest.mark.parametrize("rule", ["trmean", "phocas"])
def test_defended_aggregation_launches_the_kernels_on_cuda(cuda, rule, m):
    """One counts launch per defended aggregation, past the reference's 128
    counts lanes too; the aggregate kernel runs again only once a worker is
    ejected; the plain backend agrees."""
    u = _matrices(m, 777, cuda)["gauss"].reshape(m, 7, 111)
    counts_k = trmean_counts_hopper if rule == "trmean" else \
        phocas_counts_hopper
    agg_k = trmean_hopper if rule == "trmean" else phocas_hopper
    b = 6 if m == 20 else m // 4
    kernel_rule = make_rule(rule, RuleParams(b=b, backend="auto"))
    plain_rule = make_rule(rule, RuleParams(b=b, backend="xla"))
    for active in (torch.ones(m, device=cuda),
                   torch.tensor([0.0] * 3 + [1.0] * (m - 3), device=cuda)):
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
@pytest.mark.parametrize("m", [1, 2, 5, 20, 31, 32, 33, 64, 100, 130])
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


FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2, torch.float16: 3e-2}


def _qkv(B, S, T, H, Kv, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.tensor(x, device=device).to(dtype)

    return draw(B, S, H, hd), draw(B, T, Kv, hd), draw(B, T, Kv, hd)


def _assert_flash(q, k, v, **kw):
    before = flash_attention_hopper.launches
    got = flash_attention_hopper(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_hopper.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FLASH_TOL[q.dtype], err
    again = flash_attention_hopper(q, k, v, **kw)
    assert torch.equal(again, got)                 # bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("window,cap", [(None, None), (32, None),
                                        (None, 50.0), (100, 30.0)])
def test_flash_kernel_equals_plain_version(cuda, dtype, hd, window, cap):
    q, k, v = _qkv(2, 200, 200, 4, 2, hd, dtype, cuda)
    _assert_flash(q, k, v, window=window, cap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,Kv,causal", [
    (1, 96, 96, 2, 1, True),      # ragged: 96 = 64 + 32
    (2, 1, 1, 4, 4, True),
    (1, 33, 130, 8, 2, True),     # S < T
    (1, 130, 70, 4, 2, True),     # S > T
    (2, 77, 150, 4, 1, False),
])
def test_flash_kernel_ragged_and_noncausal(cuda, B, S, T, H, Kv, causal):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(B, S, T, H, Kv, 64, dtype, cuda, seed=S)
        _assert_flash(q, k, v, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("S", [127, 128, 129, 255])
@pytest.mark.parametrize("window", [None, 1, 64, 129])
def test_flash_kernel_at_tile_edges(cuda, dtype, S, window):
    """hd 128 around the 128-query and 64-key tiles of the f16/bf16 kernel,
    with windows that end inside, at and past a tile."""
    q, k, v = _qkv(2, S, S, 4, 2, 128, dtype, cuda, seed=S)
    _assert_flash(q, k, v, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_flash_kernel_at_granite_prefill_heads(cuda, dtype):
    q, k, v = _qkv(1, 512, 512, 32, 8, 128, dtype, cuda)
    _assert_flash(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,causal,window", [
    (129, 300, True, 64),         # S < T
    (300, 129, True, None),       # S > T
    (77, 250, False, None),
])
def test_flash_kernel_ragged_at_hd128(cuda, S, T, causal, window):
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v = _qkv(1, S, T, 8, 2, 128, dtype, cuda, seed=T)
        _assert_flash(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
def test_flash_kernel_takes_strided_views(cuda):
    """Heads sliced out of a wider tensor: a unit last stride and 16-byte
    rows are all the kernel needs."""
    q, k, v = _qkv(2, 80, 80, 6, 3, 64, torch.bfloat16, cuda)
    _assert_flash(q[:, :, 1:5], k[:, :, 1:3], v[:, :, :2])


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 64, 64, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_hopper(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="H % Kv"):
        flash_attention_hopper(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="takes"):
        flash_attention_hopper(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention_hopper(q, k.half(), v)
    with pytest.raises(ValueError, match="window"):
        flash_attention_hopper(q, k, v, window=0)
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention_hopper(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_hopper(flat[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="is on"):
        flash_attention_hopper(q, k.cpu(), v)


@pytest.mark.cuda
def test_paged_prefill_launches_the_flash_kernel_per_layer(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    cfg = get_arch("granite-8b-reduced")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    pool = model.init_paged_cache(9, 16, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    tables = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]], device=cuda)
    before = flash_attention_hopper.launches
    logits, _ = model.prefill_paged(params, pool, tokens, tables)
    assert flash_attention_hopper.launches == before + cfg.num_layers
    from repro_torch import tree as tree_util
    cpu = tree_util.map(lambda x: x.cpu(), params)
    want, _ = model.prefill_paged(cpu, model.init_paged_cache(9, 16),
                                  tokens.cpu(), tables.cpu())
    assert torch.allclose(logits.cpu(), want, atol=1e-3, rtol=1e-3)
    before = flash_attention_hopper.launches
    model.decode_step_paged(params, pool, tokens[:, :1],
                            torch.tensor([40, 40], device=cuda), tables)
    assert flash_attention_hopper.launches == before     # Sq = 1: no K6


@pytest.mark.cuda
def test_phocas_kernel_past_2_31_elements(cuda):
    """K1 on an (m, d) matrix whose element offsets pass 2^31 (an LM's
    gradient matrix does): its first and last 2^20 columns equal the plain
    version's."""
    m, d, b, n = 4, (1 << 29) + (1 << 20), 1, 1 << 20
    assert m * d > 2**31
    gen = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn((m, d), generator=gen, dtype=torch.bfloat16, device=cuda)
    got = phocas_hopper(u, b)
    for cols in (slice(d - n, d), slice(0, n)):
        _assert_same(got[cols], phocas_ref(u[:, cols], b))


@pytest.mark.cuda
def test_phocas_counts_kernel_past_2_31_elements(cuda):
    """K3 on an (m, d) matrix whose element offsets pass 2^31: its aggregate
    on the first and last 2^20 columns equals the plain version's, and its
    counts equal the plain counts summed as integers over column chunks of
    the whole matrix (each chunk's f32 count an exact integer)."""
    m, d, b, n, chunk = 4, (1 << 29) + (1 << 20), 1, 1 << 20, 1 << 24
    assert m * d > 2**31
    gen = torch.Generator(device=cuda).manual_seed(1)
    u = torch.randn((m, d), generator=gen, dtype=torch.bfloat16, device=cuda)
    got, counts = phocas_counts_hopper(u, b)
    for cols in (slice(d - n, d), slice(0, n)):
        _assert_same(got[cols], phocas_counts_ref(u[:, cols], b)[0])
    plain = torch.zeros(m, dtype=torch.int64, device=cuda)
    for s in range(0, d, chunk):
        plain += phocas_counts_ref(u[:, s:s + chunk], b)[1].long()
    assert int(plain.sum()) == b * d
    assert torch.equal(counts, plain.float())


@pytest.mark.parametrize("kernel,dropped,agg", [
    (phocas_counts_hopper, (0, 0, 1), 0.5),
    (trmean_counts_hopper, (1, 0, 1), 1.0)])
@pytest.mark.cuda
def test_counts_kernels_past_2_31_columns(cuda, kernel, dropped, agg):
    """K3 and K4 on a (3, d) matrix with d past 2^31, rows 0, 1 and 100 at
    every coordinate, b = 1: Phocas drops worker 2 and the trimmed mean
    workers 0 and 2 at every coordinate, so a count reaches d, past what
    int32 holds (d is a multiple of 2^20, exact in f32)."""
    d, n = (1 << 31) + (1 << 20), 1 << 20
    u = torch.empty((3, d), dtype=torch.bfloat16, device=cuda)
    for i, v in enumerate((0.0, 1.0, 100.0)):
        u[i].fill_(v)
    got, counts = kernel(u, 1)
    for cols in (slice(d - n, d), slice(0, n)):
        assert bool((got[cols] == agg).all())
    assert counts.tolist() == [float(d * x) for x in dropped]


@pytest.mark.cuda
def test_lm_training_launches_phocas_and_never_flash(cuda):
    """An arch model trains on the card through run_experiment: one K1
    launch a step, and attention under the worker vmap never reaches K6."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.experiment import (DataSpec, ModelSpec, ScenarioSpec,
                                        run_experiment)
    spec = ScenarioSpec(
        model=ModelSpec(kind="arch", arch="gemma2-2b-reduced", remat="full"),
        data=DataSpec(kind="tokens", seq_len=32, batch_per_worker=2),
        robust=RobustConfig(rule="phocas", b=1),
        attack=AttackConfig(name="signflip", num_byzantine=1),
        num_workers=4, steps=3, log_every=1)
    k1, k6 = phocas_hopper.launches, flash_attention_hopper.launches
    res = run_experiment(spec)
    assert phocas_hopper.launches == k1 + 3
    assert flash_attention_hopper.launches == k6
    assert all(np.isfinite(r["loss"]) for r in res.history)


@pytest.mark.cuda
def test_kernels_on_slices_of_a_two_rank_world(cuda):
    """Two gloo ranks on the card run K1 and K3 on their halves of a
    matrix's columns: the halves, all_gathered, equal the whole-matrix
    launch bit for bit, and K3's counts summed over the ranks equal its
    counts as integers."""
    from repro_torch.dist.launch import spawn
    from torch_dist_ranks import kernel_slices_rank
    for r in spawn(kernel_slices_rank, 2):
        assert r["k1"] and r["k3"]
        np.testing.assert_array_equal(r["counts"], r["whole_counts"])
        assert r["counts"][3] == r["d"] and r["ncoords"] == r["d"]


@pytest.mark.cuda
def test_fake_tensors_take_the_kernels_reckoning(cuda):
    """A FakeTensor (the dry run's, ``launch/dryrun.py``) reaches K1-K6's
    entry points, launches nothing and counts what a real launch counts:
    the same output shapes and dtypes, the same ``matrix_cost`` /
    ``flash_cost``, and no launch on the wrappers' counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn((20, 4099), generator=gen, device=cuda)
    q, k, v = _qkv(2, 96, 96, 4, 2, 64, torch.bfloat16, cuda)
    cases = [(phocas_hopper, (u, 2), build.matrix_cost("phocas", 20, 4099, 4)),
             (trmean_hopper, (u, 2), build.matrix_cost("trmean", 20, 4099, 4)),
             (phocas_counts_hopper, (u, 2),
              build.matrix_cost("phocas_counts", 20, 4099, 4)),
             (trmean_counts_hopper, (u, 2),
              build.matrix_cost("trmean_counts", 20, 4099, 4)),
             (pairwise_sq_dists_hopper, (u,),
              build.matrix_cost("krum_gram", 20, 4099, 4)),
             (flash_attention_hopper, (q, k, v),
              build.flash_cost(2, 96, 96, 4, 2, 64, 2, True, None))]
    for fn, args, cost in cases:
        with build.counting_costs() as real:
            want = fn(*args)
        launches = fn.launches
        mode = FakeTensorMode()
        fakes = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        with mode, build.counting_costs() as counted:
            got = fn(*fakes)
        assert fn.launches == launches, fn.__name__
        assert real == counted == {"flops": cost[0], "bytes": cost[1]}
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert all(build.is_fake(g) for g in got)
        assert [(g.shape, g.dtype, g.device) for g in got] == \
            [(w.shape, w.dtype, w.device) for w in want], fn.__name__
