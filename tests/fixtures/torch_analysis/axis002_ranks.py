"""A rank function beside axis002_violation.py, imported by name (no
findings of its own)."""


def sibling_rank(rank, world, x):
    return rank + world + x
