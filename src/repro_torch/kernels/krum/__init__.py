"""K5's wrapper (``kernel.py``) and its plain version (``ref.py``).

``pairwise_sq_dists``, ``krum`` and ``multikrum`` are the dispatch of
``kernels/ops.py``, as the reference's package exports its ``ops.py``."""

_OPS = ("pairwise_sq_dists", "krum", "multikrum")


def __getattr__(name):
    # Resolved at first use: kernels/ops.py imports core/aggregators.py,
    # which imports this package's ref.py.
    if name in _OPS:
        from repro_torch.kernels import ops
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
