"""Loops that a cost trace may fold.

A loop whose iterations run the same ops on tensors of the same shapes
(the streaming step's passes over the workers) runs through
:func:`iterations`.  Alone it is ``range(n)``.  Inside :func:`folding`
(``launch/trace_analysis.py::trace_cost(fold_loops=True)``), it runs its
distinct first iterations and two more, and the counters add the second
one's counts for each iteration left, as the reference's analysis folds
a scan: every iteration after the first starts from the same live
bytes, so the peak is the whole loop's.
"""
from __future__ import annotations

import contextlib
import threading

_FOLD = threading.local()


@contextlib.contextmanager
def folding(counters):
    """Fold the loops of :func:`iterations` run inside into ``counters``
    (an object with ``snapshot()`` and ``repeat(before, times)``); None
    folds nothing."""
    _FOLD.counters = counters
    try:
        yield
    finally:
        _FOLD.counters = None


def iterations(n: int, distinct: int = 0):
    """``range(n)``; inside :func:`folding`, the first ``distinct``
    iterations and two more, the second of which (it starts from the
    state that every later one starts from) stands for the
    ``n - distinct - 2`` left."""
    fold = getattr(_FOLD, "counters", None)
    if fold is None or n <= distinct + 2:
        yield from range(n)
        return
    yield from range(distinct + 1)
    before = fold.snapshot()
    yield distinct + 1
    fold.repeat(before, n - distinct - 2)
