"""The Krum Gram kernel's plain version and the Krum rules against the JAX
reference.

``pairwise_sq_dists_ref`` (the plain version of the CUDA kernel K5) is held to
the reference's Pallas ``pairwise_sq_dists_pallas`` in interpret mode and to
its direct-difference oracle at atol 1e-6 * max + 1e-3, the reference's own
bound for the Gram form (``tests/test_kernels.py::test_krum_gram_kernel``):
n_i + n_j - 2 G_ij cancels in f32 in proportion to the squared norms.  On
adversarial rows the plain version must match the reference's XLA Gram path
(``aggregators._pairwise_sq_dists``): its NaN and inf entries at the same
positions, finite entries at the same bound.  Krum scores are sums of those
distances, so they take the same bound summed over m-q-2 entries; the
selected rows are equal exactly, and the Multi-Krum mean of f32 rows agrees
at atol 1e-5.  Inputs come from a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as ragg
from repro.kernels.krum import ops as rkops
from repro.kernels.krum.kernel import pairwise_sq_dists_pallas
from repro.kernels.krum.ref import pairwise_sq_dists_ref as rdirect
from repro_torch.core import aggregators as tagg
from repro_torch.core.registry import RuleParams, make_rule
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.krum.kernel import pairwise_sq_dists_hopper
from repro_torch.kernels.krum.ref import pairwise_sq_dists_ref


def _matrix(m, d, seed, scale=10.0):
    return (scale * np.random.default_rng(seed).standard_normal((m, d))
            ).astype(np.float32)


def _gram_tol(want):
    fin = np.isfinite(want)
    return 1e-6 * (np.abs(want[fin]).max() if fin.any() else 0.0) + 1e-3


def _assert_d2_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=_gram_tol(want))


@pytest.mark.parametrize("m,d", [(5, 100), (20, 2048), (32, 4096)])
def test_gram_ref_matches_pallas_interpret_and_direct(m, d):
    u = _matrix(m, d, m)
    got = pairwise_sq_dists_ref(torch.tensor(u)).numpy()
    _assert_d2_close(got, pairwise_sq_dists_pallas(jnp.asarray(u)))
    _assert_d2_close(got, rdirect(jnp.asarray(u)))


def _adversarial(kind, m=20, d=300):
    u = _matrix(m, d, 3, scale=1.0) + 3.0
    if kind == "pm1e20":
        u[:6] = 1e20 * np.sign(u[:6])          # omniscient-style rows
    elif kind == "rows1e20":
        u[2] = 1e20
        u[5] = 1e20
        u[8] = -1e20
    elif kind == "nan_inf":
        u[1, ::9] = np.nan
        u[4, 3::11] = np.inf
        u[6, 5::13] = -np.inf
    elif kind == "zeros":
        u[:] = 0.0
    return u


@pytest.mark.parametrize("kind", ["pm1e20", "rows1e20", "nan_inf", "zeros"])
def test_gram_ref_matches_xla_path_on_adversarial_rows(kind):
    u = _adversarial(kind)
    got = pairwise_sq_dists_ref(torch.tensor(u)).numpy()
    want = np.asarray(ragg._pairwise_sq_dists(jnp.asarray(u)))
    _assert_d2_close(got, want)
    if kind == "rows1e20":
        # inf - inf between two rows of one sign; inf between rows of
        # opposite signs (G = -inf) and to every benign row
        assert np.isnan(got[2, 5]) and np.isnan(got[5, 2])
        assert np.isposinf(got[2, 8]) and np.isposinf(got[8, 5])
        assert np.isposinf(got[2, 0]) and np.isposinf(got[0, 5])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gram_ref_upcasts_low_precision(dtype):
    u = torch.tensor(_matrix(8, 64, 1)).to(dtype)
    want = pairwise_sq_dists_ref(u.float())
    got = pairwise_sq_dists_hopper(u)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gram_wrapper_takes_any_m_and_counts_no_cpu_launch():
    before = pairwise_sq_dists_hopper.launches
    for m in (1, 5, 64, 100):
        u = torch.tensor(_matrix(m, 33, m))
        got = pairwise_sq_dists_hopper(u)
        assert got.shape == (m, m)
        torch.testing.assert_close(got, pairwise_sq_dists_ref(u))
        assert torch.equal(tops.pairwise_sq_dists(u), got)
    assert pairwise_sq_dists_hopper.launches == before


def test_gram_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="dtype|take"):
        pairwise_sq_dists_hopper(torch.zeros((5, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        pairwise_sq_dists_hopper(torch.zeros((5, 4, 2)))
    with pytest.raises(ValueError, match="empty"):
        pairwise_sq_dists_hopper(torch.zeros((5, 0)))
    with pytest.raises(ValueError, match="CUDA"):
        build.launch_gram(torch.zeros((5, 4)))


def test_gram_build_signature_and_blocks():
    """K5 has its own C signature (no b, an (m, m) output and a scratch
    buffer) and its block count fills the card without outgrowing the
    scratch cap."""
    assert "krum_gram" in build.SOURCES
    text = (build.CSRC / "krum_gram.cu").read_text()
    assert ('extern "C" int repro_krum_gram(const void* u, void* out, '
            'void* scratch, int m,') in text
    assert "atomicAdd" not in text
    assert len(build._argtypes("krum_gram")) == 8
    assert build.gram_blocks(20, 118_282, 132) == 8 * 132
    assert build.gram_blocks(20, 100, 132) == 2              # two tiles
    big = build.gram_blocks(3000, 10**7, 132)
    assert big * 3000 * 3001 // 2 <= build.GRAM_SCRATCH_FLOATS
    assert big >= 1


# ---------------------------------------------------------------------------
# Krum scores and selection
# ---------------------------------------------------------------------------

def _scores_close(got, want, u):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    d2 = np.asarray(ragg._pairwise_sq_dists(jnp.asarray(u)))
    k = u.shape[0]
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=k * _gram_tol(d2))


@pytest.mark.parametrize("m,q", [(8, 2), (12, 3), (20, 6)])
def test_krum_and_multikrum_match_reference(m, q):
    u = _matrix(m, 257, m)
    u[: q] += 40.0                                    # q outliers
    t = torch.tensor(u)
    _scores_close(tagg.krum_scores(t, q), ragg.krum_scores(jnp.asarray(u), q),
                  u)
    want = np.asarray(ragg.krum(jnp.asarray(u), q))
    np.testing.assert_array_equal(tagg.krum(t, q).numpy(), want)
    np.testing.assert_array_equal(tops.krum(t, q).numpy(),
                                  np.asarray(rkops.krum(jnp.asarray(u), q)))
    for k in (None, 1, m - q - 2):
        want = np.asarray(ragg.multikrum(jnp.asarray(u), q, k))
        np.testing.assert_allclose(tagg.multikrum(t, q, k).numpy(), want,
                                   atol=1e-5)
        np.testing.assert_allclose(tops.multikrum(t, q, k).numpy(), want,
                                   atol=1e-5)


def test_krum_rules_reduce_every_backend_on_a_tree():
    u = _matrix(10, 3 * 41, 5).reshape(10, 3, 41)
    u[:2] *= -20.0
    want = {"krum": ragg.krum(jnp.asarray(u), 2),
            "multikrum": ragg.multikrum(jnp.asarray(u), 2)}
    for rule in ("krum", "multikrum"):
        for backend in ("auto", "pallas", "xla"):
            got = make_rule(rule, RuleParams(q=2, backend=backend)).reduce(
                torch.tensor(u))
            assert got.shape == (3, 41)
            np.testing.assert_allclose(got.numpy(), np.asarray(want[rule]),
                                       atol=1e-5)


def test_exact_ties_select_the_lowest_indices():
    """All-zero rows tie on every score: Krum takes worker 0, Multi-Krum
    workers 0..k-1, as ``argmin`` and ``top_k`` do in the reference."""
    u = np.zeros((9, 16), np.float32)
    scores = tagg.krum_scores(torch.tensor(u), 2)
    rscores = ragg.krum_scores(jnp.asarray(u), 2)
    assert torch.equal(scores, torch.zeros(9))
    k = 9 - 2 - 2
    assert (tagg.lowest_scores(scores, k).tolist() == list(range(k))
            == np.asarray(jax.lax.top_k(-rscores, k)[1]).tolist())
    assert int(torch.argmin(scores)) == int(jnp.argmin(rscores)) == 0


def test_lowest_scores_orders_inf_and_nan_as_top_k():
    s = np.array([np.nan, np.inf, 1.0, np.inf, np.nan, 0.5, 1.0], np.float32)
    want = np.asarray(jax.lax.top_k(-jnp.asarray(s), 7)[1])
    assert tagg.lowest_scores(torch.tensor(s), 7).tolist() == want.tolist()
    assert int(torch.argmin(torch.tensor(s))) == int(jnp.argmin(s))


def test_1e20_rows_score_inf_and_the_aggregate_stays_finite():
    """Six omniscient-style rows at +-1e20: their distances to each other
    are NaN (inf - inf) and to the benign rows inf, so after the NaN-last
    sort their scores are inf, the benign scores finite, and both rules
    return finite aggregates, as in the reference."""
    u = _adversarial("pm1e20")
    t = torch.tensor(u)
    got = tagg.krum_scores(t, 6)
    want = ragg.krum_scores(jnp.asarray(u), 6)
    _scores_close(got, want, u[6:])
    assert torch.isposinf(got[:6]).all() and torch.isfinite(got[6:]).all()
    for fn, rfn in ((tagg.krum, ragg.krum), (tagg.multikrum, ragg.multikrum)):
        agg = fn(t, 6)
        assert torch.isfinite(agg).all()
        np.testing.assert_allclose(agg.numpy(),
                                   np.asarray(rfn(jnp.asarray(u), 6)),
                                   atol=1e-5)


@pytest.mark.parametrize("m,q", [(5, 3), (5, 4), (4, 2)])
def test_krum_needs_m_minus_q_minus_2_positive(m, q):
    t = torch.zeros((m, 4))
    for fn in (tagg.krum_scores, tagg.krum, tops.krum, tagg.multikrum):
        with pytest.raises(ValueError, match="m - q - 2"):
            fn(t, q)
    with pytest.raises(ValueError):
        ragg.krum_scores(jnp.zeros((m, 4)), q)
