"""K2's and K4's wrappers (``kernel.py``) and their plain versions
(``ref.py``).

``trmean`` is the dispatch of ``kernels/ops.py``, as the reference's
package exports its ``ops.py``."""

_OPS = ("trmean",)


def __getattr__(name):
    # Resolved at first use: kernels/ops.py imports core/aggregators.py,
    # which imports this package's ref.py.
    if name in _OPS:
        from repro_torch.kernels import ops
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
