"""Models in Python of the selection kernels' algorithms (``csrc/selection.cuh``
and ``csrc/selection_wide.cuh``), held to the port's plain versions and to the
JAX reference on the CPU.

- The register kernels sort a column padded with +inf to its bucket N with
  the reference's ``batcher_pairs(next_pow2(N))`` pruned to the pairs whose
  upper index is < N (``batcher_walk``): it must sort every N-input 0-1
  vector (exhaustively for N <= 20, by hypothesis above) and give
  ``torch.sort``'s values on +inf-padded columns.
- K1's window search stages the windows' upper ends at the launch-uniform
  offset k - 1 (``nearest_window_mean``) and must pick the window and sum
  that ``nearest_window_sum`` does, in both packages.
- Past 64 workers K1/K2 sort each column in one warp's registers
  (``warp_sort``: the mirror-form bitonic network, in-lane and
  ``__shfl_xor_sync`` stages) and one thread per column sums it in
  ascending order, bit for bit ``trimmed_mean_of_sorted`` and
  ``nearest_window_sum``; the padded column layout hits 32 banks.
Inputs come from numpy seeds.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import selection as rsel
from repro_torch.core import selection as tsel
from repro_torch.kernels import build

CSRC = Path(build.__file__).resolve().parent / "csrc"


def next_bucket(m: int) -> int:
    return next(n for n in build.REGISTER_BUCKETS if m <= n)


def bucket_floor(n: int) -> int:
    return max((x for x in build.REGISTER_BUCKETS if x < n), default=0)


def batcher_walk(n: int):
    """The compare-exchanges of ``selection.cuh::batcher_walk(n, ...)`` in
    its order: the schedule of batcher_pairs(next_pow2(n)) keeping the pairs
    whose upper register is < n."""
    mp = rsel.next_pow2(n)
    pairs = []
    p = 1
    while p < mp:
        k = p
        while k >= 1:
            for j in range(k % p, mp - k, 2 * k):
                for i in range(k):
                    if ((i + j) // (2 * p) == (i + j + k) // (2 * p)
                            and i + j + k < n):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def test_source_constants_match_the_wrappers():
    """The bucket set and the wide switch point the sources compile are the
    ones ``build`` states; the serving run's m = 3 and the paper's m = 20
    land in a bucket equal to or just above m."""
    sel = (CSRC / "selection.cuh").read_text()
    chain = re.search(r"next_bucket\(int m\) \{(.*?)\}", sel, re.S).group(1)
    sizes = [int(x) for x in re.findall(r"\? (\d+)", chain)]
    sizes.append(int(re.search(r": (\d+);", chain).group(1)))
    assert tuple(sizes) == build.REGISTER_BUCKETS
    assert int(re.search(r"kRegisterMaxM = (\d+);", sel).group(1)) == \
        build.REGISTER_BUCKETS[-1] == 64
    wide = (CSRC / "selection_wide.cuh").read_text()
    assert int(re.search(r"kWarpSortMaxM = (\d+);", wide).group(1)) == \
        build.WARP_SORT_MAX_M
    assert next_bucket(3) == 4 and next_bucket(20) == 20
    assert bucket_floor(20) == 16 and bucket_floor(4) == 0


@pytest.mark.parametrize("n", list(range(1, 65)))
def test_pruned_walk_is_the_reference_schedule_pruned(n):
    full = rsel.batcher_pairs(rsel.next_pow2(n))
    assert batcher_walk(n) == [p for p in full if p[1] < n]


def _network_01(n: int, bits: np.ndarray) -> np.ndarray:
    """The pruned network on 0-1 columns: (n, V) bool -> sorted (n, V)."""
    x = bits.copy()
    for i, l in batcher_walk(n):
        a, c = x[i].copy(), x[l]
        x[i] = a & c
        x[l] = a | c
    return x


def _assert_sorted_01(x: np.ndarray) -> None:
    assert not (x[:-1] & ~x[1:]).any()


@pytest.mark.parametrize("n", list(range(1, 21)))
def test_pruned_network_sorts_every_01_vector(n):
    """0-1 principle: a comparator network sorts every input iff it sorts
    every 0-1 input.  All 2^n of them, as bit planes."""
    v = np.arange(1 << n, dtype=np.int64)
    bits = ((v[None, :] >> np.arange(n)[:, None]) & 1).astype(bool)
    _assert_sorted_01(_network_01(n, bits))


@pytest.mark.parametrize("n", [24, 32, 48, 64])
@given(seed=st.integers(0, 2**31 - 1), density=st.floats(0.02, 0.98))
@settings(max_examples=15, deadline=None)
def test_pruned_network_sorts_01_vectors_by_hypothesis(n, seed, density):
    rng = np.random.default_rng(seed)
    bits = rng.random((n, 4096)) < density
    _assert_sorted_01(_network_01(n, bits))


def _network(n: int, col: np.ndarray) -> np.ndarray:
    """The pruned network on f32 columns (n, d), fminf/fmaxf as the kernel."""
    x = col.copy()
    for i, l in batcher_walk(n):
        a, c = x[i].copy(), x[l].copy()
        x[i] = np.fmin(a, c)
        x[l] = np.fmax(a, c)
    return x


def _column(m: int, d: int, seed: int) -> np.ndarray:
    """(m, d) f32 with ties, +-inf, NaN, 1e20 rows and signed zeros."""
    rng = np.random.default_rng(seed)
    u = rng.choice(np.asarray([-1.0, 0.0, -0.0, 1.0, 2.5], np.float32),
                   size=(m, d))
    u[:, d // 2:] = rng.standard_normal((m, d - d // 2))
    hit = rng.random((m, d)) < 0.15
    u[hit] = rng.choice(np.asarray([np.inf, -np.inf, np.nan, 1e20, -1e20],
                                   np.float32), size=int(hit.sum()))
    return u


def _padded_keys(u: np.ndarray, n: int) -> np.ndarray:
    """load_column: NaN -> +inf, rows m .. n-1 of +inf."""
    m, d = u.shape
    v = np.full((n, d), np.inf, np.float32)
    v[:m] = np.where(np.isnan(u), np.inf, u)
    return v


@pytest.mark.parametrize("n", list(build.REGISTER_BUCKETS))
def test_pruned_network_on_padded_columns_gives_torch_sort(n):
    for m in range(bucket_floor(n) + 1, n + 1):
        u = _column(m, 64, 7 * n + m)
        got = _network(n, _padded_keys(u, n))
        want = torch.stack(tsel.sorted_rows(tsel.worker_rows(
            torch.tensor(u)))).numpy()
        np.testing.assert_array_equal(got[:m], want)
        assert np.isposinf(got[m:]).all()


def _nan_max(a, b):
    return np.where(np.isnan(a) | np.isnan(b), np.float32(np.nan),
                    np.fmax(a, b))


def staged_window_sum(v: np.ndarray, m: int, b: int, center: np.ndarray):
    """``nearest_window_mean``'s search on the sorted (N, d) column: stage
    the upper ends v[k-1 .. m-1] at slots 0..b, score window w by
    nan_max(center - v[w], slot[w] - center), the strictly smallest
    winning, then the masked ascending sum of the best window."""
    n, d = v.shape
    k = m - b
    slots = np.full(((n + 1) // 2, d), np.float32(-7.0))   # never read
    for p in range(bucket_floor(n) // 2, n):
        if k - 1 <= p < m:
            slots[p - (k - 1)] = v[p]
    with np.errstate(invalid="ignore"):
        best = _nan_max(center - v[0], slots[0] - center)
        best_w = np.zeros(d, np.int32)
        for w in range(1, (n + 1) // 2):
            if w <= b:
                score = _nan_max(center - v[w], slots[w] - center)
                better = score < best
                best = np.where(better, score, best)
                best_w = np.where(better, w, best_w)
    total = np.zeros(d, np.float32)
    with np.errstate(invalid="ignore"):      # inf - inf outside the window
        for p in range(n):
            keep = (best_w <= p) & (p < best_w + k)
            total = np.where(keep, total + v[p], total)
    return total, best_w


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 13, 17, 20, 24, 31, 33, 48,
                               49, 64])
def test_staged_window_search_equals_nearest_window_sum(m):
    n = next_bucket(m)
    u = _column(m, 96, 100 + m)
    rows = tsel.worker_rows(torch.tensor(u))
    srows = tsel.sorted_rows(rows)
    rrows = rsel.sorted_rows(rsel.worker_rows(jnp.asarray(u)))
    v = _network(n, _padded_keys(u, n))
    bmax = (m + 1) // 2 - 1
    for b in sorted({0, 1, bmax} & set(range(bmax + 1))):
        center = tsel.trimmed_mean_of_sorted(srows, b)
        total, w = staged_window_sum(v, m, b, center.numpy())
        want, want_w = tsel.nearest_window_sum(srows, center, b)
        np.testing.assert_array_equal(total, want.numpy())
        np.testing.assert_array_equal(w, want_w.numpy())
        rtotal, rw = rsel.nearest_window_sum(rrows, jnp.asarray(center), b)
        np.testing.assert_array_equal(total, np.asarray(rtotal))
        np.testing.assert_array_equal(w, np.asarray(rw))


def warp_sort_model(col: np.ndarray) -> np.ndarray:
    """``selection_wide.cuh::warp_sort`` on (P, d) columns, P = 32 R: the
    warp loads key 32 r + lane into lane's register r, runs the mirror-form
    bitonic stages (in-lane below stride R, lane ^ (stride / R) above), and
    lane l's register r holds sorted position R l + r."""
    p, d = col.shape
    r_ = p // 32
    lanes = np.arange(32)
    x = col.reshape(r_, 32, d).transpose(1, 0, 2).copy()   # x[lane, r]

    def lane_stage(partner, sources, lower):
        y = x[partner][:, sources]
        lo = lower[:, None, None]
        return np.where(lo, np.fmin(x, y), np.fmax(x, y))

    k = 2
    while k <= p:
        if k <= r_:
            for r in range(r_):
                if r & (k // 2) == 0:
                    q = r ^ (k - 1)
                    a, c = x[:, r].copy(), x[:, q].copy()
                    x[:, r], x[:, q] = np.fmin(a, c), np.fmax(a, c)
        else:
            x = lane_stage(lanes ^ (k // r_ - 1), np.arange(r_)[::-1],
                           (lanes & (k // (2 * r_))) == 0)
        j = k // 4
        while j >= 1:
            if j >= r_:
                x = lane_stage(lanes ^ (j // r_), np.arange(r_),
                               (lanes & (j // r_)) == 0)
            else:
                for r in range(r_):
                    if r & j == 0:
                        a, c = x[:, r].copy(), x[:, r | j].copy()
                        x[:, r], x[:, r | j] = np.fmin(a, c), np.fmax(a, c)
            j //= 2
        k *= 2
    return x.reshape(p, d)


@pytest.mark.parametrize("p", [128, 256, 1024])
def test_warp_register_bitonic_sort_sorts(p):
    for m in (p // 2 + 1, p - 7, p):
        u = _column(m, 24, p + m)
        keys = np.full((p, 24), np.inf, np.float32)
        keys[:m] = np.where(np.isnan(u), np.inf, u)
        got = warp_sort_model(keys)
        np.testing.assert_array_equal(got, np.sort(keys, axis=0))


def column_pos(q):
    return q + (q >> 5)


@pytest.mark.parametrize("p", [128, 256, 512, 1024])
def test_warp_sort_column_layout_hits_32_banks(p):
    """Every shared access of ``warp_sort_kernel`` that a warp makes at once
    touches 32 distinct banks: the tile store (one row of 32 columns), the
    warp's load of register r, its write-back of register r, and the 32
    summing threads (one column each) at one sorted position."""
    r_ = p // 32
    stride = p + p // 32 + 1
    lanes = np.arange(32)

    def distinct(addr):
        assert len(set((np.asarray(addr) % 32).tolist())) == 32

    for r in range(0, p, 7):
        distinct(lanes * stride + column_pos(r))
    for r in range(r_):
        distinct(column_pos(32 * r + lanes))
        distinct(column_pos(r_ * lanes + r))
    for q in range(0, p, 5):
        distinct(lanes * stride + column_pos(q))
    # the spread positions stay inside the column and keep their order
    pos = column_pos(np.arange(p))
    assert pos[-1] < stride and (np.diff(pos) > 0).all()


def _ascending_sum(v: np.ndarray, lo: int, length: int) -> np.ndarray:
    """wide_window_sum with one thread per column: from 0.0, ascending."""
    acc = np.zeros(v.shape[1], np.float32)
    with np.errstate(invalid="ignore"):      # +inf and -inf in one window
        for q in range(lo, lo + length):
            acc = acc + v[q]
    return acc


def _wide_phocas_model(v: np.ndarray, m: int, b: int, center: np.ndarray):
    """wide_nearest_window_mean's sum: the window search on the sorted
    column, then the ascending sum of the best window."""
    k = m - b
    d = v.shape[1]
    with np.errstate(invalid="ignore"):
        best = _nan_max(center - v[0], v[k - 1] - center)
        best_w = np.zeros(d, np.int64)
        for w in range(1, b + 1):
            score = _nan_max(center - v[w], v[w + k - 1] - center)
            better = score < best
            best = np.where(better, score, best)
            best_w = np.where(better, w, best_w)
    total = np.zeros(d, np.float32)
    for c in range(d):
        total[c] = _ascending_sum(v[:, c:c + 1], int(best_w[c]), k)[0]
    return total


@pytest.mark.parametrize("m", [65, 96, 128, 200, 1024])
def test_per_column_ascending_sums_equal_the_plain_versions(m):
    """The sorted column through the padded layout, summed one thread per
    column from 0.0 in ascending order: the b-trimmed sum and its mean
    equal ``trimmed_mean_of_sorted``, and the best window's sum equals
    ``nearest_window_sum``, bit for bit."""
    p = rsel.next_pow2(m)
    u = _column(m, 16, 3 * m)
    keys = _padded_keys(u, p)
    sorted_col = warp_sort_model(keys)
    spread = np.full((p + p // 32 + 1, 16), np.float32(-3.0))
    spread[column_pos(np.arange(p))] = sorted_col
    v = spread[column_pos(np.arange(p))]
    srows = tsel.sorted_rows(tsel.worker_rows(torch.tensor(u)))
    bmax = (m + 1) // 2 - 1
    for b in sorted({0, 1, m // 4, bmax}):
        n = m - 2 * b
        center = tsel.trimmed_mean_of_sorted(srows, b)
        kept = _ascending_sum(v, b, n)
        np.testing.assert_array_equal(
            kept / np.float32(n) if n > 1 else kept, center.numpy())
        total = _wide_phocas_model(v, m, b, center.numpy())
        want, _ = tsel.nearest_window_sum(srows, center, b)
        np.testing.assert_array_equal(total, want.numpy())
