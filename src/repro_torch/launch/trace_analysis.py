"""The cost of one traced call, per rank: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference compiles its per-device SPMD program and reads the HLO text.
Here the program runs eagerly, as it would on the card: on fake tensors in
a fake world in the dry run (``launch/dryrun.py``), or on the card's own
tensors in ``obs/profile.py::compiled_cost``.  :func:`trace_cost` calls it
once under PyTorch dispatch modes, which see every aten op and every
``c10d`` collective, and returns:

* ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, the
  products and convolutions of the forward and the backward pass (the
  reference's ``2 · prod(out) · contracted size`` of each dot);
* ``bytes_accessed``: the operand and result bytes of every aten op that is
  neither a view nor a bare allocation, XLA's reckoning of bytes accessed
  op by op; ``write_bytes``: the result bytes alone, as ``hlo_analysis``
  counts each op's output once (with no fusion here, every op's);
* ``collective_bytes`` / ``collective_counts`` by the reference's
  ``COLLECTIVE_KINDS``: each ``c10d`` call and the bytes of its output (the
  tensors it fills), as the reference counts a collective's output shape.
  Under the NCCL forms (``dist/collectives.py``, the dry run's default)
  each collective is one call, and a reduce-scatter counts under
  "reduce-scatter" with its output bytes; under the gloo forms a CUDA
  all_gather or all_to_all goes in calls of at most ``STAGE_BYTES``, each
  of which counts once, their bytes summing to the whole, and a
  reduce-scatter is an all-reduce of the whole operand;
* ``peak_bytes``: the most bytes live at once, from the arguments' bytes
  at the start, counted by storage (a view or an in-place result adds
  nothing; a storage counts until it is freed), and ``argument_bytes`` /
  ``output_bytes``: the distinct storages of the arguments and of the
  outputs;
* the hand-written kernels' own reckoning (``kernels/build.py::
  counting_costs``): ``kernel_flops`` and ``kernel_bytes`` by the bound of
  each launch, and ``kernels``, each launch's name and operand shape.
  ``flops`` and ``bytes`` add them to ``dot_flops`` and ``bytes_accessed``.
  As ``hlo_analysis`` counts no custom call, ``write_bytes`` and
  ``dot_flops`` leave the kernels out.

There are no ``loops``: the reference recovers while-loop trip counts
because XLA's cost analysis counts a loop body once; an eager trace runs
every layer's ops as they come, so there is no trip count to recover.
With ``fold_loops``, a loop that runs through ``obs/loops.py::
iterations`` (the streaming step's passes over the workers) is traced
folded, as the reference's scan is analysed (that module's docstring).
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch

from repro_torch.obs.loops import folding

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d ops by the reference's collective kinds
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# aten ops that allocate or re-describe a tensor without reading or writing
# its elements (views are told apart by their schema, ``OpOverload.is_view``).
_NO_TRAFFIC = frozenset({"empty.memory_format", "empty_strided.default",
                         "empty_like.default", "new_empty.default",
                         "new_empty_strided.default", "_unsafe_view.default",
                         "lift_fresh.default"})


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a view of a counted
    storage adds nothing)."""
    seen = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def _count_mode():
    """A dispatch mode adding up bytes accessed and written, the c10d
    collectives, and the live bytes by storage (``.peak``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.writes = 0
            self.coll_bytes = {k: 0 for k in COLLECTIVE_KINDS}
            self.coll_counts = {k: 0 for k in COLLECTIVE_KINDS}
            self.live = self.peak = 0
            self._held = {}

        def hold(self, tensors) -> None:
            """Count the storages of ``tensors`` live until freed."""
            for t in tensors:
                s = t.untyped_storage()
                key = s._cdata
                if key in self._held:
                    continue
                n = s.nbytes()
                self._held[key] = n
                self.live += n
                weakref.finalize(s, self._free, key)
            self.peak = max(self.peak, self.live)

        def _free(self, key) -> None:
            self.live -= self._held.pop(key, 0)

        def totals(self) -> tuple:
            return (self.bytes, self.writes, dict(self.coll_bytes),
                    dict(self.coll_counts))

        def add(self, before: tuple, times: int) -> None:
            """Count what was counted since ``before`` ``times`` more."""
            b, w, cb, cc = before
            self.bytes += times * (self.bytes - b)
            self.writes += times * (self.writes - w)
            for k in COLLECTIVE_KINDS:
                self.coll_bytes[k] += times * (self.coll_bytes[k] - cb[k])
                self.coll_counts[k] += times * (self.coll_counts[k] - cc[k])

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = f"{func._opname}.{func._overloadname}"
            results = _tensors(out)
            if not func.is_view and name not in _NO_TRAFFIC:
                n = _nbytes(results)
                self.bytes += n + _nbytes(_tensors((args, kwargs)))
                kind = (_C10D_KINDS.get(func._opname)
                        if func.namespace == "c10d" else None)
                if kind is not None:        # the tensors it fills
                    n = _nbytes(_tensors(args[0]))
                    self.coll_bytes[kind] += n
                    self.coll_counts[kind] += 1
                self.writes += n
            self.hold(results)
            return out

    return Count()


class _Folds:
    """The counters a folded loop repeats (``obs/loops.py::iterations``)."""

    def __init__(self, flops, count, kernels, calls):
        self.flops, self.count, self.kernels, self.calls = (
            flops, count, kernels, calls)
        self.extra_flops = 0

    def snapshot(self) -> tuple:
        return (self.flops.get_total_flops(), self.count.totals(),
                dict(self.kernels), len(self.calls))

    def repeat(self, before: tuple, times: int) -> None:
        flops, counts, kernels, ncalls = before
        self.extra_flops += times * (self.flops.get_total_flops() - flops)
        self.count.add(counts, times)
        for k in ("flops", "bytes"):
            self.kernels[k] += times * (self.kernels[k] - kernels[k])
        self.calls.extend(self.calls[ncalls:] * times)


def trace_cost(fn, *args, fold_loops: bool = False, **kwargs) -> Dict:
    """Call ``fn(*args, **kwargs)`` once under the counters and return its
    costs (the module docstring's keys); the output is dropped.
    ``fold_loops``: trace the loops of ``obs/loops.py::iterations``
    folded."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.build import counting_costs
    calls = []
    with counting_costs(calls) as kernels, \
            FlopCounterMode(display=False) as flops, _count_mode() as count:
        folds = _Folds(flops, count, kernels, calls)
        count.hold(_tensors((args, kwargs)))
        arguments = count.live
        with folding(folds if fold_loops else None):
            out = fn(*args, **kwargs)
        output_bytes = storage_bytes(out)
        del out
    coll = dict(count.coll_bytes)
    dot = float(flops.get_total_flops() + folds.extra_flops)
    return {"dot_flops": dot,
            "flops": dot + kernels["flops"],
            "bytes_accessed": float(count.bytes + kernels["bytes"]),
            "write_bytes": float(count.writes),
            "collective_bytes": coll,
            "collective_counts": dict(count.coll_counts),
            "collective_total_bytes": float(sum(coll.values())),
            "argument_bytes": arguments, "output_bytes": output_bytes,
            "peak_bytes": count.peak,
            "kernel_flops": kernels["flops"],
            "kernel_bytes": kernels["bytes"],
            "kernels": calls}
