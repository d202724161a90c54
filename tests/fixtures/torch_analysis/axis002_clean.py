"""Clean twin of axis002_violation.py."""
from axis002_ranks import sibling_rank

from repro_torch.dist.launch import spawn


def two_args_rank(rank, world, a, b):
    return a + b


def defaults_rank(rank, world, a, b=1, c=2):
    return a + b + c


def star_rank(rank, world, *xs):
    return sum(xs)


def run(xs):
    return (spawn(two_args_rank, 2, 1, 2), spawn(defaults_rank, 2, 1),
            spawn(defaults_rank, 2, 1, 2, 3), spawn(star_rank, 2, 1, 2, 3),
            spawn(two_args_rank, 2, *xs), spawn(sibling_rank, 4, 1))
