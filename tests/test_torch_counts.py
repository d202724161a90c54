"""repro_torch's counts kernels K3/K4 (plain versions, on the CPU) against
the JAX reference.

The wrappers ``phocas_counts_hopper`` / ``trmean_counts_hopper`` take their
plain versions for a CPU tensor.  They are held to the reference's Pallas
counts kernels (interpret mode) on finite, moderate inputs, and to its XLA
selection path (``selection.trim_family(with_scores=True)``) on rows at
+-1e20 and NaN, where the reference's extraction variants subtract the
dropped values from a total (ROADMAP queue 3).  Aggregates agree at atol
1e-4, with the boundary-tie allowance of ``tests/test_kernels.py`` for
phocas; counts agree exactly.  Inputs come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from test_kernels import _assert_phocas_close

from repro.core import selection as rsel
from repro.kernels.phocas.kernel import phocas_counts_pallas
from repro.kernels.phocas.ops import phocas_with_counts as rphocas_wc
from repro.kernels.trmean.kernel import trmean_counts_pallas
from repro.kernels.trmean.ops import trmean_with_counts as rtrmean_wc
from repro_torch.core import selection as tsel
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.phocas.kernel import phocas_counts_hopper
from repro_torch.kernels.phocas.ref import phocas_counts_ref, phocas_ref
from repro_torch.kernels.trmean.kernel import trmean_counts_hopper
from repro_torch.kernels.trmean.ref import trmean_counts_ref, trmean_ref

ATOL = 1e-4
PORT = {"phocas": (phocas_counts_hopper, phocas_counts_ref, phocas_ref),
        "trmean": (trmean_counts_hopper, trmean_counts_ref, trmean_ref)}
PALLAS = {"phocas": phocas_counts_pallas, "trmean": trmean_counts_pallas}


def _matrix(m, d, seed):
    return (10.0 * np.random.default_rng(seed).standard_normal((m, d))
            ).astype(np.float32)


def _check_agg(name, u, b, got, want):
    if name == "phocas":
        _assert_phocas_close(jnp.asarray(u), b, got, want, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("m,b", [(8, 2), (8, 3), (20, 2), (20, 9)])
@pytest.mark.parametrize("name", ["phocas", "trmean"])
def test_counts_match_pallas_interpret(name, m, b):
    u = _matrix(m, 600, 31 * m + b)
    want_agg, want_counts = PALLAS[name](jnp.asarray(u), b)
    wrapper, ref, _ = PORT[name]
    for agg, counts in (wrapper(torch.tensor(u), b),
                        ref(torch.tensor(u), b)):
        assert agg.dtype == counts.dtype == torch.float32
        assert counts.shape == (m,)
        _check_agg(name, u, b, agg.numpy(), np.asarray(want_agg))
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(want_counts))


def _adversarial(kind, m=20, d=96):
    rng = np.random.default_rng(17)
    u = (3.0 + rng.uniform(-1.0, 1.0, (m, d))).astype(np.float32)
    u[:, 40:48] = 2.5                                 # exact ties
    if kind == "pm1e20":
        u[3, :6] = -1e20
        u[9, 6:12] = 1e20
    elif kind == "nan":
        u[5, :7] = np.nan
        u[11, 3:5] = np.nan
    elif kind == "inf":
        u[5, :5] = np.inf
        u[6, 5:9] = -np.inf
    return u


@pytest.mark.parametrize("kind", ["pm1e20", "nan", "inf"])
@pytest.mark.parametrize("name", ["phocas", "trmean"])
def test_counts_match_xla_path_on_adversarial_rows(name, kind):
    u = _adversarial(kind)
    wrapper, ref, agg_ref = PORT[name]
    for b in (1, 2, 6, 9):
        want_agg, want_counts, _ = rsel.trim_family(
            jnp.asarray(u), b, name, with_scores=True)
        for agg, counts in (wrapper(torch.tensor(u), b),
                            ref(torch.tensor(u), b)):
            np.testing.assert_allclose(agg.numpy(), np.asarray(want_agg),
                                       atol=ATOL, err_msg=f"b={b}")
            np.testing.assert_array_equal(counts.numpy(),
                                          np.asarray(want_counts),
                                          err_msg=f"b={b}")
            # the aggregate is K1/K2's, bit for bit
            np.testing.assert_array_equal(
                agg.numpy(), agg_ref(torch.tensor(u), b).numpy())
        if b >= 2:      # at most two adversarial values per coordinate
            assert np.all(np.abs(np.asarray(want_agg) - 3.0) < 1.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_inputs(dtype):
    u = torch.tensor(_matrix(16, 512, 3)).to(dtype)
    ref_u = jnp.asarray(u.float().numpy())
    for name, (wrapper, _, _) in PORT.items():
        agg, counts = wrapper(u, 3)
        assert agg.dtype == counts.dtype == torch.float32
        want_agg, want_counts, _ = rsel.trim_family(ref_u, 3, name,
                                                    with_scores=True)
        np.testing.assert_allclose(agg.numpy(), want_agg, atol=1e-2)
        np.testing.assert_array_equal(counts.numpy(), want_counts)


@pytest.mark.parametrize("name", ["phocas", "trmean"])
def test_with_counts_b0_is_the_mean_and_no_counts(name, monkeypatch):
    """b = 0 gives the plain mean and zero counts without reaching the
    wrapper, as the reference's ``*_with_counts`` do."""
    def unreachable(u, b):
        raise AssertionError("b = 0 reached the counts wrapper")

    monkeypatch.setattr(tops, f"{name}_counts_hopper", unreachable)
    u = _matrix(8, 33, 5)
    fn = {"phocas": tops.phocas_with_counts,
          "trmean": tops.trmean_with_counts}[name]
    agg, counts = fn(torch.tensor(u), 0)
    ragg, rcounts = {"phocas": rphocas_wc, "trmean": rtrmean_wc}[name](
        jnp.asarray(u), 0)
    np.testing.assert_allclose(agg.numpy(), np.asarray(ragg), atol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert agg.dtype == counts.dtype == torch.float32


@pytest.mark.parametrize("name", ["phocas", "trmean"])
def test_with_counts_facade_matches_reference_ops(name):
    u = _matrix(20, 300, 9)
    fn = {"phocas": tops.phocas_with_counts,
          "trmean": tops.trmean_with_counts}[name]
    rfn = {"phocas": rphocas_wc, "trmean": rtrmean_wc}[name]
    for b in (1, 4, 9):
        agg, counts = fn(torch.tensor(u), b)
        ragg, rcounts = rfn(jnp.asarray(u), b)
        _check_agg(name, u, b, agg.numpy(), np.asarray(ragg))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))


def test_counts_wrappers_refuse_what_the_kernels_do_not_take():
    for wrapper in (phocas_counts_hopper, trmean_counts_hopper):
        cap = build.MAX_M[wrapper.__name__.replace("_hopper", "")]
        assert cap >= 4096
        with pytest.raises(ValueError,
                           match=f"m <= {cap} workers, got m={cap + 1}"):
            wrapper(torch.zeros((cap + 1, 4)), 2)
        wrapper(torch.zeros((129, 4)), 2)   # past the reference's 128 lanes
        with pytest.raises(ValueError, match="out of range"):
            wrapper(torch.zeros((8, 4)), 4)
        with pytest.raises(ValueError, match="dtype|take"):
            wrapper(torch.zeros((5, 4), dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="CUDA"):
        build.launch("phocas_counts", torch.zeros((5, 4)), 1)


def test_plain_cpu_path_never_counts_as_a_launch():
    before = (phocas_counts_hopper.launches, trmean_counts_hopper.launches)
    t = torch.tensor(_matrix(8, 16, 1))
    phocas_counts_hopper(t, 2)
    trmean_counts_hopper(t, 2)
    assert (phocas_counts_hopper.launches,
            trmean_counts_hopper.launches) == before


def test_every_source_has_its_entry_point():
    """Each CUDA source defines the extern "C" entry point build.py binds,
    with the counts pointer exactly where the counts signature has it; the
    flash-attention kernel's (q, k, v, o, ...) entry point has as many
    parameters as its ctypes binding."""
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        if name == "flash_attn":
            head = ('extern "C" int repro_flash_attn(const void* q, '
                    'const void* k, const void* v,')
            assert head in text, name
            params = text.split(head)[1].split(")")[0].count(",") + 4
            assert params == len(build._argtypes(name)), name
            continue
        head = f'extern "C" int repro_{name}(const void* u, void* out, '
        assert head in text, name
        has_counts = "void* counts" in text.split(head)[1].split(")")[0]
        assert has_counts == name.endswith("_counts"), name


def _threshold_walk_drops(u: torch.Tensor, b: int) -> torch.Tensor:
    """K4's counting rule (``csrc/selection.cuh::tally_trim_drops``) as a
    plain loop over the workers: an (m, d) bool mask of the coordinates at
    which each worker is dropped.  lo = sorted[b-1] and hi = sorted[m-b];
    worker i drops below iff key_i < lo, or key_i == lo and the keys below lo
    plus the earlier workers at lo number fewer than b; above iff key_i > hi,
    or key_i == hi and the keys below hi plus the earlier workers at hi
    number at least m - b."""
    keys = torch.where(torch.isnan(u), torch.inf, u.float())
    m = keys.shape[0]
    drops = torch.zeros(keys.shape, dtype=torch.bool)
    if b == 0:
        return drops
    srt = torch.sort(keys, dim=0).values
    lo, hi = srt[b - 1], srt[m - b]
    below_lo = (keys < lo).sum(0)
    below_hi = (keys < hi).sum(0)
    seen_lo = torch.zeros_like(below_lo)
    seen_hi = torch.zeros_like(below_hi)
    for i in range(m):
        x = keys[i]
        at_lo, at_hi = x == lo, x == hi
        drops[i] = ((x < lo) | (at_lo & (below_lo + seen_lo < b))
                    | (x > hi) | (at_hi & (below_hi + seen_hi >= m - b)))
        seen_lo += at_lo.long()
        seen_hi += at_hi.long()
    return drops


@st.composite
def _tie_heavy(draw):
    """(u, b): m in 1..64, every valid b, entries from a set of 3 values
    with +-inf and NaN sprinkled in at a drawn rate.  One width, so the
    reference's eager ops compile once."""
    m = draw(st.integers(1, 64))
    b = draw(st.integers(0, (m + 1) // 2 - 1))
    d = 32
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    values = draw(st.sampled_from([(-1.0, 0.0, 1.0), (2.5, 3.0, 1e20),
                                   (0.0, -0.0, 7.0)]))
    u = rng.choice(np.asarray(values, dtype=np.float32), size=(m, d))
    rate = draw(st.sampled_from([0.0, 0.05, 0.3]))
    special = np.asarray([np.inf, -np.inf, np.nan], dtype=np.float32)
    hit = rng.random((m, d)) < rate
    u[hit] = rng.choice(special, size=int(hit.sum()))
    return u, b


@given(_tie_heavy())
@settings(max_examples=40, deadline=None)
def test_threshold_walk_drops_equal_stable_rank_drops(case):
    """K4's O(m) rule names exactly the workers whose stable rank r has
    r < b or r >= m - b: against the port's ranks, the reference's ranks
    and the plain counts."""
    u, b = case
    m = u.shape[0]
    got = _threshold_walk_drops(torch.tensor(u), b)
    ranks = tsel.stable_ranks(tsel.worker_rows(torch.tensor(u)))
    want = torch.stack(tsel.trim_drop_masks(ranks, b, "trmean"))
    assert torch.equal(got, want)
    rranks = np.stack([np.asarray(r) for r in rsel.stable_ranks(
        rsel.worker_rows(jnp.asarray(u)))])
    np.testing.assert_array_equal(
        got.numpy(), (rranks < b) | (rranks >= m - b))
    _, counts = trmean_counts_ref(torch.tensor(u), b)
    assert torch.equal(got.sum(1).float(), counts)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 20, 33, 64])
def test_threshold_walk_drops_on_fixed_tie_matrices(m):
    """Every valid b on one tie-heavy matrix per m: values in {-1, 0, 1},
    a constant row block and a row of alternating +-inf."""
    rng = np.random.default_rng(m)
    u = rng.integers(-1, 2, (m, 48)).astype(np.float32)
    u[m // 3:m // 3 + max(1, m // 4)] = 0.0
    u[m - 1, ::2] = np.inf
    u[m - 1, 1::2] = -np.inf
    rows = tsel.worker_rows(torch.tensor(u))
    for b in range((m + 1) // 2):
        want = torch.stack(tsel.trim_drop_masks(tsel.stable_ranks(rows), b,
                                                "trmean"))
        assert torch.equal(_threshold_walk_drops(torch.tensor(u), b), want), b


def _far_walk_drops(u: torch.Tensor, b: int) -> torch.Tensor:
    """K3's counting rule for m <= 64 (``csrc/selection.cuh::
    tally_far_drops``) as a plain loop over the workers: an (m, d) bool mask
    of the coordinates at which each worker is dropped.  W is the best
    window's score of the window search (``nearest_window_mean``); worker i
    drops iff its distance exceeds W, or equals W while the distances below
    W plus the earlier workers at W number at least m - b.  A NaN or
    infinite center makes every window's score, so W, NaN: nobody drops."""
    keys = torch.where(torch.isnan(u), torch.inf, u.float())
    m = keys.shape[0]
    drops = torch.zeros(keys.shape, dtype=torch.bool)
    if b == 0:
        return drops
    srt = torch.sort(keys, dim=0).values
    center = tsel.trimmed_mean_of_sorted(list(srt), b)
    k = m - b
    width = torch.maximum(center - srt[0], srt[k - 1] - center)
    for w in range(1, b + 1):
        score = torch.maximum(center - srt[w], srt[w + k - 1] - center)
        width = torch.where(score < width, score, width)
    dist = (keys - center).abs()
    below = (dist < width).sum(0)
    seen = torch.zeros_like(below)
    for i in range(m):
        at = dist[i] == width
        drops[i] = (dist[i] > width) | (at & (below + seen >= m - b))
        seen += at.long()
    return drops


def _phocas_rank_drops(u: np.ndarray, b: int):
    """The plain counts' drops: stable ranks of |row - center| (port), and
    the reference's ranks of the same distances."""
    rows = tsel.worker_rows(torch.tensor(u))
    center = tsel.trimmed_mean_of_sorted(tsel.sorted_rows(rows), b)
    ranks = tsel.stable_ranks([(r - center).abs() for r in rows])
    want = torch.stack(tsel.trim_drop_masks(ranks, b, "phocas"))
    rrows = rsel.worker_rows(jnp.asarray(u))
    rcenter = jnp.asarray(center.numpy())
    rranks = np.stack([np.asarray(r) for r in rsel.stable_ranks(
        [jnp.abs(r - rcenter) for r in rrows])])
    return want, rranks >= u.shape[0] - b


@given(_tie_heavy())
@settings(max_examples=40, deadline=None)
def test_far_walk_drops_equal_stable_rank_drops(case):
    """K3's O(m) rule names exactly the workers whose distance's stable rank
    r has r >= m - b: against the port's ranks, the reference's ranks and the
    plain counts, with ties, +-inf, NaN keys and NaN or infinite centers."""
    u, b = case
    got = _far_walk_drops(torch.tensor(u), b)
    want, rwant = _phocas_rank_drops(u, b)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), rwant)
    _, counts = phocas_counts_ref(torch.tensor(u), b)
    assert torch.equal(got.sum(1).float(), counts)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 20, 33, 64])
def test_far_walk_drops_on_fixed_tie_matrices(m):
    """Every valid b on one tie-heavy matrix per m, with a column of
    alternating +-inf (a NaN center), a column mostly +inf (a center of
    +inf) and a column of equal distances on both sides of the center."""
    rng = np.random.default_rng(100 + m)
    u = rng.integers(-1, 2, (m, 48)).astype(np.float32)
    u[m // 3:m // 3 + max(1, m // 4)] = 0.0
    u[m - 1, ::2] = np.inf
    u[m - 1, 1::2] = -np.inf
    u[0::2, 0] = np.inf
    u[1::2, 0] = -np.inf
    u[: max(1, (3 * m) // 4), 1] = np.inf
    u[:, 2] = np.where(np.arange(m) % 2 == 0, -1.0, 1.0)
    for b in range((m + 1) // 2):
        want, rwant = _phocas_rank_drops(u, b)
        got = _far_walk_drops(torch.tensor(u), b)
        assert torch.equal(got, want), b
        np.testing.assert_array_equal(got.numpy(), rwant)


def _wide_sorted_order(keys: np.ndarray, pad: float) -> np.ndarray:
    """The shared-memory variant's sort (``csrc/selection_wide.cuh``
    ``warp_bitonic_sort`` with ``pair_before``), column by column: the
    bitonic network over the padded power of two p on (key, index) pairs,
    ordered by key with NaN after every number, then by index; padding keys
    ``pad`` with indices >= m.  Returns the (p, d) worker index at each
    sorted position."""
    m, d = keys.shape
    p = 1 << max(0, (m - 1).bit_length())
    key = np.full((p, d), pad, dtype=np.float32)
    key[:m] = keys
    idx = np.repeat(np.arange(p)[:, None], d, axis=1)
    t = np.arange(p // 2)
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
            lo, hi = i, i + j
            up = ((i & k) == 0)[:, None]
            a, c = key[lo], key[hi]
            ia, ic = idx[lo], idx[hi]

            def before(x, ix, y, iy):
                xn, yn = np.isnan(x), np.isnan(y)
                both = np.where(xn == yn, ix < iy, yn)
                num = (x < y) | ((x == y) & (ix < iy))
                return np.where(xn | yn, both, num)

            swap = np.where(up, before(c, ic, a, ia), before(a, ia, c, ic))
            key[lo], key[hi] = np.where(swap, c, a), np.where(swap, a, c)
            idx[lo], idx[hi] = np.where(swap, ic, ia), np.where(swap, ia, ic)
            j >>= 1
        k <<= 1
    return idx


def _positions(order: np.ndarray, m: int) -> np.ndarray:
    """(m, d) sorted position of each worker from the (p, d) order."""
    pos = np.empty((m, order.shape[1]), dtype=np.int64)
    cols = np.arange(order.shape[1])
    for q in range(m):
        pos[order[q], cols] = q
    return pos


@st.composite
def _wide_case(draw):
    """(u, b): m in 65..128, every valid b, entries from a set of 3 values
    with +-inf and NaN sprinkled in at a drawn rate."""
    m = draw(st.integers(65, 128))
    b = draw(st.integers(0, (m + 1) // 2 - 1))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    values = draw(st.sampled_from([(-1.0, 0.0, 1.0), (2.5, 3.0, 1e20),
                                   (0.0, -0.0, 7.0)]))
    u = rng.choice(np.asarray(values, dtype=np.float32), size=(m, 16))
    rate = draw(st.sampled_from([0.0, 0.05, 0.3, 0.6]))
    special = np.asarray([np.inf, -np.inf, np.nan], dtype=np.float32)
    hit = rng.random((m, 16)) < rate
    u[hit] = rng.choice(special, size=int(hit.sum()))
    return u, b


@given(_wide_case())
@settings(max_examples=25, deadline=None)
def test_wide_pair_sort_positions_are_stable_ranks(case):
    """Past m = 64 the shared-memory variant's position of a worker in its
    sorted (key, index) pairs is its stable rank (the plain path's double
    argsort), so K4's drops (positions < b or >= m - b) and K3's (distance
    positions >= m - b) equal the plain versions' counts as integers."""
    u, b = case
    m = u.shape[0]
    keys = np.where(np.isnan(u), np.inf, u)
    pos = _positions(_wide_sorted_order(keys, np.inf), m)
    ranks = torch.stack(tsel.stable_ranks(tsel.worker_rows(torch.tensor(u))))
    np.testing.assert_array_equal(pos, ranks.numpy())
    _, counts = trmean_counts_ref(torch.tensor(u), b)
    np.testing.assert_array_equal(((pos < b) | (pos >= m - b)).sum(1),
                                  counts.numpy())

    rows = tsel.worker_rows(torch.tensor(u))
    center = tsel.trimmed_mean_of_sorted(tsel.sorted_rows(rows), b).numpy()
    with np.errstate(invalid="ignore"):          # inf - inf in a column
        dist = np.abs(keys - center)
    dpos = _positions(_wide_sorted_order(dist, np.nan), m)
    _, pcounts = phocas_counts_ref(torch.tensor(u), b)
    np.testing.assert_array_equal((dpos >= m - b).sum(1), pcounts.numpy())
